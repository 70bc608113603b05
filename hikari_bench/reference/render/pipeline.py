"""The frame of the benchmark's configurations, in plain PyTorch:

    outputs, state' = render_frame(scene, camera, state, settings)

G-buffer -> albedo -> direct (sun) -> emissive -> indirect (+ spatial
reuse) -> denoise x3 -> tone mapping -> SMAA TU4x -> TAA -> the NaN ->
albedo fallback (reference render graph PREPASS -> LIGHT -> POST_PROCESS
-> OVERLAY, src/lib.rs:332-365). ``check_supported`` refuses every setting
that the frame does not follow (FSR1, HDR, bloom, FXAA, truncated frames,
remat, emissive spatial reuse, statistics).
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from hikari_bench.reference.config import RenderSettings, Taa, UpscaleMode
from hikari_bench.reference.diff import clip_gradient
from hikari_bench.reference.render.camera import Camera
from hikari_bench.reference.render.denoise import deferred_planes, denoise_channel
from hikari_bench.reference.render.filters import nearest_sample
from hikari_bench.reference.render.gbuffer import render_gbuffer
from hikari_bench.reference.render.light import direct_lit_pass, full_screen_albedo, indirect_lit_pass
from hikari_bench.reference.render.noise import blue_noise_bank
from hikari_bench.reference.render.restir import Reservoir, compress_reservoir, decompress_reservoir
from hikari_bench.reference.render.smaa import smaa_tu4x
from hikari_bench.reference.render.spatial import spatial_reuse_pass
from hikari_bench.reference.render.taa import taa_jasmine
from hikari_bench.reference.render.tonemap import tone_mapping
from hikari_bench.reference.render.types import FrameState, GBuffer, RenderOutputs
from hikari_bench.reference.scene.buffers import SceneBuffers
from hikari_bench.reference.utils import map_tensors, resolve_device, uv_grid

_RESERVOIRS = (
    "direct_temporal",
    "emissive_temporal",
    "indirect_temporal",
    "de_spatial",
    "indirect_spatial",
)

_noise_banks: dict = {}

# The control's precision (``lowered``): while set, every float output of
# a pass and of the post chain's stages is rounded to it and back.
_control_dtype: list = []


@contextmanager
def lowered(dtype=torch.bfloat16):
    """Render as the control: every pass's float outputs in ``dtype``."""
    _control_dtype.append(dtype)
    try:
        yield
    finally:
        _control_dtype.pop()


def _lower(x):
    if _control_dtype and isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(_control_dtype[-1]).to(x.dtype)
    return x


def noise_bank_on(device) -> torch.Tensor:
    """The blue-noise bank as a tensor on ``device`` (uploaded once)."""
    key = str(torch.device(device))
    if key not in _noise_banks:
        _noise_banks[key] = torch.from_numpy(blue_noise_bank()).to(device)
    return _noise_banks[key]


def check_supported(settings: RenderSettings) -> None:
    """Raise ValueError for a setting this frame does not follow."""
    off = {
        "upscale other than SMAA TU4x": settings.upscale.mode != UpscaleMode.SMAA_TU4X,
        "a fractional upscale ratio": not float(settings.upscale_ratio).is_integer(),
        "TAA other than Jasmine": settings.taa != Taa.JASMINE,
        "hdr": settings.hdr, "bloom": settings.bloom, "fxaa": settings.fxaa,
        "stop_after": settings.stop_after is not None,
        "remat": settings.remat or settings.channel_remat,
        "emissive_spatial_reuse": settings.emissive_spatial_reuse,
        "collect_stats": settings.collect_stats,
    }
    bad = [k for k, v in off.items() if v]
    if bad:
        raise ValueError(f"the reference frame does not follow: {', '.join(bad)}")


def _firewall(out, name):
    """Gradient firewall at a pass boundary: every float output passes
    ``clip_gradient`` (identity forward)."""
    return map_tensors(
        lambda x: clip_gradient(_lower(x), 1e4, name) if x.is_floating_point() else x, out
    )


def _pass(name, fn, *args, **kwargs):
    """One pass, ``fn(*args, **kwargs)``, behind its gradient firewall."""
    return _firewall(fn(*args, **kwargs), name)


def render_frame(scene: SceneBuffers, camera: Camera, state: FrameState, settings: RenderSettings):
    """Render one frame. Returns (RenderOutputs, FrameState)."""
    check_supported(settings)
    dev = scene.device
    noise_bank = noise_bank_on(dev)
    frame_number = int(state.frame_number)

    if settings.reservoir_f16:
        state = state.replace(**{k: decompress_reservoir(getattr(state, k)) for k in _RESERVOIRS})

    gbuffer = _pass("prepass", render_gbuffer, scene, camera, frame_number, settings)
    albedo = _pass("albedo", full_screen_albedo, scene, camera, gbuffer)

    direct_out, direct_var, direct_temporal, de_spatial, bg, _ = _pass(
        "direct_lit", direct_lit_pass,
        scene, camera, gbuffer, state.direct_temporal, state.de_spatial, noise_bank,
        frame_number, settings, emissive_lit=False, render_emissive=True,
    )

    rh, rw = settings.render_size
    if settings.emissive_lit and scene.num_emissives > 0:
        em_out, em_var, em_temporal, de_spatial, _, _ = _pass(
            "emissive_lit", direct_lit_pass,
            scene, camera, gbuffer, state.emissive_temporal, de_spatial, noise_bank,
            frame_number, settings, emissive_lit=True, render_emissive=False,
        )
    else:
        em_out = torch.zeros((rh, rw, 3), device=dev)
        em_var = torch.zeros((rh, rw), device=dev)
        em_temporal = state.emissive_temporal

    indirect_spatial = state.indirect_spatial
    if settings.indirect_bounces > 0:
        ind_out, ind_var, ind_temporal, indirect_spatial, _, _ = _pass(
            "indirect_lit", indirect_lit_pass,
            scene, camera, gbuffer, state.indirect_temporal, indirect_spatial, noise_bank,
            frame_number, settings,
        )
        if settings.indirect_spatial_reuse:
            ind_out, ind_var, indirect_spatial = _pass(
                "indirect_spatial", spatial_reuse_pass,
                scene, camera, gbuffer, ind_temporal, indirect_spatial, ind_var, frame_number,
                settings, emissive_lit=False,
            )
    else:
        ind_out = torch.zeros((rh, rw, 3), device=dev)
        ind_var = torch.zeros((rh, rw), device=dev)
        ind_temporal = state.indirect_temporal

    # ---- POST PROCESS ----
    if settings.denoise:
        albedo_rr = deferred_planes((albedo,), settings, frame_number)[0]
        direct_d, em_d, ind_d = _pass(
            "denoise",
            lambda: tuple(denoise_channel(rad, var, albedo_rr, gbuffer, frame_number, settings)
                          for rad, var in ((direct_out, direct_var), (em_out, em_var),
                                           (ind_out, ind_var))),
        )
    else:
        direct_d, em_d, ind_d = direct_out, em_out, ind_out

    fg = (~bg).to(torch.float32)[..., None]

    def with_alpha(rgb):
        return torch.cat([rgb, fg], dim=-1)

    tonemapped = tone_mapping(
        with_alpha(direct_d), with_alpha(em_d) * fg, with_alpha(ind_d) * fg,
        settings.clear_color,
    )
    tonemapped = clip_gradient(_lower(tonemapped), 1e4, "tonemap")

    upscaled = smaa_tu4x(tonemapped, state.prev_upscaled, gbuffer, state.prev_gbuffer,
                         frame_number)
    upscaled = clip_gradient(_lower(upscaled), 1e4, "smaa")
    image = taa_jasmine(upscaled, state.prev_taa, gbuffer, state.prev_gbuffer,
                        settings.clear_color, settings.upscale_ratio)
    image = clip_gradient(_lower(image), 1e4, "taa")
    prev_taa = image

    # The overlay's NaN -> albedo fallback (overlay.wgsl:42).
    nan_mask = torch.isnan(image).any(-1, keepdim=True)
    albedo_out = albedo
    if image.shape[:2] != albedo.shape[:2]:
        albedo_out = nearest_sample(albedo, uv_grid(image.shape[:2], dev))
    image = torch.where(
        nan_mask, torch.cat([albedo_out, torch.ones_like(albedo_out[..., :1])], dim=-1), image
    )

    reservoirs = dict(
        direct_temporal=direct_temporal,
        emissive_temporal=em_temporal,
        indirect_temporal=ind_temporal,
        de_spatial=de_spatial,
        indirect_spatial=indirect_spatial,
    )
    if settings.reservoir_f16:
        reservoirs = {k: compress_reservoir(v) for k, v in reservoirs.items()}

    new_state = FrameState(
        frame_number=frame_number + 1,
        prev_gbuffer=gbuffer,
        prev_tonemapped=tonemapped,
        prev_taa=prev_taa,
        prev_upscaled=upscaled,
        **reservoirs,
    )
    outputs = RenderOutputs(
        image=image,
        albedo=albedo,
        direct=direct_d,
        emissive=em_d,
        indirect=ind_d,
        tonemapped=tonemapped,
        stats=None,
    )
    return outputs, new_state


def initial_state(settings: RenderSettings, device=None) -> FrameState:
    """The cross-frame state with the per-pass shapes, zeroed."""
    device = resolve_device(device)
    rh, rw = settings.render_size
    h, w = settings.output_size

    def res():
        r = Reservoir.zeros((rh, rw), device)
        return compress_reservoir(r) if settings.reservoir_f16 else r

    return FrameState(
        frame_number=0,
        prev_gbuffer=GBuffer.zeros((h, w), device),
        direct_temporal=res(),
        emissive_temporal=res(),
        indirect_temporal=res(),
        de_spatial=res(),
        indirect_spatial=res(),
        prev_tonemapped=torch.zeros((rh, rw, 4), device=device),
        prev_taa=torch.zeros((2 * rh, 2 * rw, 4), device=device),
        prev_upscaled=torch.zeros((2 * rh, 2 * rw, 4), device=device),
    )
