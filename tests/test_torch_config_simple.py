"""Parity of whole frames of the ``simple`` config with ``hikari_tpu``: two
frames at 48x63 without the post chain, as ``test_torch_config_minimal.py``
checks them and with its tolerances."""

import pytest
import torch

from test_torch_config_minimal import check_frame, config_world

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def world():
    return config_world("simple")


@pytest.mark.parametrize("frame", [0, 1])
def test_simple_frame_matches(world, frame):
    check_frame(world, frame)
