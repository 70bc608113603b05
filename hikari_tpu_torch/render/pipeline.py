"""The frame pipeline — the port of ``hikari_tpu.render.pipeline``:

    outputs, state' = render_frame(scene, camera, state, settings)

The frame goes G-buffer -> albedo -> direct (sun) -> emissive ->
indirect -> tone mapping -> overlay (reference render graph
PREPASS -> LIGHT -> POST_PROCESS -> OVERLAY, src/lib.rs:332-365).

This slice covers the frame without its post chain: ``render_frame``
raises NotImplementedError for denoise, upscaling, TAA, spatial reuse,
HDR, bloom, FXAA and the profiling truncations, which are not ported yet.
"""

from __future__ import annotations

import torch

from hikari_tpu_torch.config import RenderSettings, Taa, UpscaleMode
from hikari_tpu_torch.diff import clip_gradient
from hikari_tpu_torch.render.camera import Camera
from hikari_tpu_torch.render.gbuffer import render_gbuffer
from hikari_tpu_torch.render.light import direct_lit_pass, full_screen_albedo, indirect_lit_pass
from hikari_tpu_torch.render.noise import blue_noise_bank
from hikari_tpu_torch.render.restir import Reservoir, compress_reservoir, decompress_reservoir
from hikari_tpu_torch.render.tonemap import tone_mapping
from hikari_tpu_torch.render.types import FrameState, GBuffer, RenderOutputs
from hikari_tpu_torch.scene.buffers import SceneBuffers
from hikari_tpu_torch.utils import luminance, map_tensors, resolve_device

_RESERVOIRS = (
    "direct_temporal",
    "emissive_temporal",
    "indirect_temporal",
    "de_spatial",
    "indirect_spatial",
)

_noise_banks: dict = {}


def noise_bank_on(device) -> torch.Tensor:
    """The blue-noise bank as a tensor on ``device`` (uploaded once)."""
    key = str(torch.device(device))
    if key not in _noise_banks:
        _noise_banks[key] = torch.from_numpy(blue_noise_bank()).to(device)
    return _noise_banks[key]


def check_supported(settings: RenderSettings) -> None:
    """Raise NotImplementedError for a setting this port does not cover
    yet: it never skips one in silence."""
    missing = []
    if settings.denoise:
        missing.append("denoise")
    if settings.upscale.mode != UpscaleMode.NONE:
        missing.append(f"upscale={settings.upscale.mode.value}")
    if settings.taa != Taa.NONE:
        missing.append(f"taa={settings.taa.value}")
    if settings.indirect_spatial_reuse:
        missing.append("indirect_spatial_reuse")
    if settings.emissive_spatial_reuse:
        missing.append("emissive_spatial_reuse")
    for flag in ("hdr", "bloom", "fxaa"):
        if getattr(settings, flag):
            missing.append(flag)
    if settings.stop_after is not None:
        missing.append(f"stop_after={settings.stop_after!r}")
    if missing:
        raise NotImplementedError(
            "not ported yet (see ROADMAP.md queue 1): " + ", ".join(missing)
        )


def _firewall(out, name):
    """Gradient firewall at a pass boundary: every float output passes
    ``clip_gradient`` (identity forward), as in the JAX pipeline."""
    return map_tensors(
        lambda x: clip_gradient(x, 1e4, name) if x.is_floating_point() else x, out
    )


def render_frame(
    scene: SceneBuffers,
    camera: Camera,
    state: FrameState,
    settings: RenderSettings,
    noise_bank=None,
):
    """Render one frame. Returns (RenderOutputs, FrameState)."""
    check_supported(settings)
    dev = scene.device
    if noise_bank is None:
        noise_bank = noise_bank_on(dev)
    frame_number = int(state.frame_number)

    if settings.reservoir_f16:
        state = state.replace(**{k: decompress_reservoir(getattr(state, k)) for k in _RESERVOIRS})

    gbuffer = _firewall(render_gbuffer(scene, camera, frame_number, settings), "prepass")
    albedo = _firewall(full_screen_albedo(scene, camera, gbuffer), "albedo")

    direct_out, _, direct_temporal, de_spatial, bg, _ = _firewall(
        direct_lit_pass(
            scene, camera, gbuffer, state.direct_temporal, state.de_spatial, noise_bank,
            frame_number, settings, emissive_lit=False, render_emissive=True,
        ),
        "direct_lit",
    )

    rh, rw = settings.render_size
    if settings.emissive_lit and scene.num_emissives > 0:
        em_out, _, em_temporal, de_spatial, _, _ = _firewall(
            direct_lit_pass(
                scene, camera, gbuffer, state.emissive_temporal, de_spatial, noise_bank,
                frame_number, settings, emissive_lit=True, render_emissive=False,
            ),
            "emissive_lit",
        )
    else:
        em_out = torch.zeros((rh, rw, 3), device=dev)
        em_temporal = state.emissive_temporal

    indirect_spatial = state.indirect_spatial
    if settings.indirect_bounces > 0:
        ind_out, _, ind_temporal, indirect_spatial, _, _ = _firewall(
            indirect_lit_pass(
                scene, camera, gbuffer, state.indirect_temporal, indirect_spatial, noise_bank,
                frame_number, settings,
            ),
            "indirect_lit",
        )
    else:
        ind_out = torch.zeros((rh, rw, 3), device=dev)
        ind_temporal = state.indirect_temporal

    # ---- POST PROCESS (tone mapping only in this slice) ----
    fg = (~bg).to(torch.float32)[..., None]

    def with_alpha(rgb):
        return torch.cat([rgb, fg], dim=-1)

    tonemapped = tone_mapping(
        with_alpha(direct_out), with_alpha(em_out) * fg, with_alpha(ind_out) * fg,
        settings.clear_color,
    )
    tonemapped = clip_gradient(tonemapped, 1e4, "tonemap")

    # ---- OVERLAY: NaN -> albedo fallback (src/shaders/overlay.wgsl:42) ----
    nan_mask = torch.isnan(tonemapped).any(-1, keepdim=True)
    image = torch.where(
        nan_mask, torch.cat([albedo, torch.ones_like(albedo[..., :1])], dim=-1), tonemapped
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
        prev_taa=state.prev_taa,
        prev_upscaled=state.prev_upscaled,
        **reservoirs,
    )
    stats = None
    if settings.collect_stats:
        stats = {
            "background_fraction": bg.to(torch.float32).mean(),
            "nonfinite_pixels": nan_mask.to(torch.int32).sum(),
            "mean_luminance_direct": luminance(direct_out).mean(),
            "mean_luminance_emissive": luminance(em_out).mean(),
            "mean_luminance_indirect": luminance(ind_out).mean(),
            "mean_temporal_count": reservoirs["direct_temporal"].count.mean(),
            "mean_reservoir_lifetime": reservoirs["direct_temporal"].lifetime.mean(),
        }

    outputs = RenderOutputs(
        image=image,
        albedo=albedo,
        direct=direct_out,
        emissive=em_out,
        indirect=ind_out,
        tonemapped=tonemapped,
        stats=stats,
    )
    return outputs, new_state


def initial_state(settings: RenderSettings, device=None) -> FrameState:
    """Allocate the cross-frame state with the per-pass shapes of the JAX
    package's ``initial_state``, on ``device`` (the CUDA card unless the
    caller names another; raises without a card)."""
    device = resolve_device(device)
    h, w = settings.output_size
    rh, rw = settings.render_size
    taa_hw = (2 * rh, 2 * rw) if settings.upscale.mode == UpscaleMode.SMAA_TU4X else (rh, rw)

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
        prev_taa=torch.zeros(taa_hw + (4,), device=device),
        prev_upscaled=torch.zeros((2 * rh, 2 * rw, 4), device=device),
    )
