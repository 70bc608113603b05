"""The train step (counterpart of ``hikari_tpu.parallel``): the image loss
and one fwd+grad frame over the differentiable scene leaves. Only the
unsharded step is ported; the sharded one and the multi-device meshes
are ROADMAP.md queue 1 item 1."""

from hikari_tpu_torch.parallel.sharding import DIFF_LEAVES, make_train_step, render_loss

__all__ = ["DIFF_LEAVES", "make_train_step", "render_loss"]
