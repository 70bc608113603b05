"""The frame pipeline — the port of ``hikari_tpu.render.pipeline``:

    outputs, state' = render_frame(scene, camera, state, settings)

The frame goes G-buffer -> albedo -> direct (sun) -> emissive (+ spatial
reuse) -> indirect (+ spatial reuse) -> denoise x3 -> tone mapping ->
SMAA TU4x -> TAA -> overlay (reference render graph PREPASS -> LIGHT ->
POST_PROCESS -> OVERLAY, src/lib.rs:332-365).

``render_frame`` raises NotImplementedError for HDR, bloom, FXAA, FSR1
and the profiling truncations, which are not ported yet.
"""

from __future__ import annotations

import torch

from hikari_tpu_torch.config import RenderSettings, Taa, UpscaleMode
from hikari_tpu_torch.diff import clip_gradient
from hikari_tpu_torch.render.camera import Camera
from hikari_tpu_torch.render.denoise import deferred_planes, denoise_channel
from hikari_tpu_torch.render.filters import nearest_sample
from hikari_tpu_torch.render.gbuffer import render_gbuffer
from hikari_tpu_torch.render.light import direct_lit_pass, full_screen_albedo, indirect_lit_pass
from hikari_tpu_torch.render.noise import blue_noise_bank
from hikari_tpu_torch.render.restir import Reservoir, compress_reservoir, decompress_reservoir
from hikari_tpu_torch.render.smaa import smaa_tu4x
from hikari_tpu_torch.render.spatial import spatial_reuse_pass
from hikari_tpu_torch.render.taa import taa_jasmine
from hikari_tpu_torch.render.tonemap import tone_mapping
from hikari_tpu_torch.render.types import FrameState, GBuffer, RenderOutputs
from hikari_tpu_torch.scene.buffers import SceneBuffers
from hikari_tpu_torch.utils import luminance, map_tensors, resolve_device, uv_grid

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
    if settings.upscale.mode == UpscaleMode.FSR1:
        missing.append(f"upscale={settings.upscale.mode.value}")
    for flag in ("hdr", "bloom", "fxaa"):
        if getattr(settings, flag):
            missing.append(flag)
    if settings.stop_after is not None:
        missing.append(f"stop_after={settings.stop_after!r}")
    if missing:
        raise NotImplementedError(
            "not ported yet (see ROADMAP.md queue 1): " + ", ".join(missing)
        )


def _albedo_at_render_res(albedo, settings: RenderSettings, frame_number: int):
    """The full-res albedo at each render pixel's jittered deferred uv
    (denoise.wgsl:148-150)."""
    return deferred_planes((albedo,), settings, frame_number)[0]


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

    direct_out, direct_var, direct_temporal, de_spatial, bg, _ = _firewall(
        direct_lit_pass(
            scene, camera, gbuffer, state.direct_temporal, state.de_spatial, noise_bank,
            frame_number, settings, emissive_lit=False, render_emissive=True,
        ),
        "direct_lit",
    )

    rh, rw = settings.render_size
    if settings.emissive_lit and scene.num_emissives > 0:
        em_out, em_var, em_temporal, de_spatial, _, _ = _firewall(
            direct_lit_pass(
                scene, camera, gbuffer, state.emissive_temporal, de_spatial, noise_bank,
                frame_number, settings, emissive_lit=True, render_emissive=False,
            ),
            "emissive_lit",
        )
        if settings.emissive_spatial_reuse:
            em_out, em_var, de_spatial = _firewall(
                spatial_reuse_pass(scene, camera, gbuffer, em_temporal, de_spatial, em_var,
                                   frame_number, settings, emissive_lit=True),
                "emissive_spatial",
            )
    else:
        em_out = torch.zeros((rh, rw, 3), device=dev)
        em_var = torch.zeros((rh, rw), device=dev)
        em_temporal = state.emissive_temporal

    indirect_spatial = state.indirect_spatial
    if settings.indirect_bounces > 0:
        ind_out, ind_var, ind_temporal, indirect_spatial, _, _ = _firewall(
            indirect_lit_pass(
                scene, camera, gbuffer, state.indirect_temporal, indirect_spatial, noise_bank,
                frame_number, settings,
            ),
            "indirect_lit",
        )
        if settings.indirect_spatial_reuse:
            ind_out, ind_var, indirect_spatial = _firewall(
                spatial_reuse_pass(scene, camera, gbuffer, ind_temporal, indirect_spatial,
                                   ind_var, frame_number, settings, emissive_lit=False),
                "indirect_spatial",
            )
    else:
        ind_out = torch.zeros((rh, rw, 3), device=dev)
        ind_var = torch.zeros((rh, rw), device=dev)
        ind_temporal = state.indirect_temporal

    # ---- POST PROCESS ----
    if settings.denoise:
        # The reference dispatches one denoise pipeline per channel
        # (post_process.rs:1190); the JAX package vmaps the three.
        albedo_rr = _albedo_at_render_res(albedo, settings, frame_number)
        direct_d, em_d, ind_d = (
            clip_gradient(
                denoise_channel(rad, var, albedo_rr, gbuffer, frame_number, settings), 1e4,
                "denoise",
            )
            for rad, var in ((direct_out, direct_var), (em_out, em_var), (ind_out, ind_var))
        )
    else:
        direct_d, em_d, ind_d = direct_out, em_out, ind_out

    fg = (~bg).to(torch.float32)[..., None]

    def with_alpha(rgb):
        return torch.cat([rgb, fg], dim=-1)

    # Post-chain gradient firewalls after tone mapping, SMAA and TAA, as in
    # the JAX pipeline.
    tonemapped = tone_mapping(
        with_alpha(direct_d), with_alpha(em_d) * fg, with_alpha(ind_d) * fg,
        settings.clear_color,
    )
    tonemapped = clip_gradient(tonemapped, 1e4, "tonemap")

    current = tonemapped
    prev_upscaled = state.prev_upscaled
    if settings.upscale.mode == UpscaleMode.SMAA_TU4X:
        current = smaa_tu4x(current, state.prev_upscaled, gbuffer, state.prev_gbuffer,
                            frame_number)
        current = clip_gradient(current, 1e4, "smaa")
        prev_upscaled = current

    prev_taa = state.prev_taa
    if settings.taa == Taa.JASMINE:
        current = taa_jasmine(current, state.prev_taa, gbuffer, state.prev_gbuffer,
                              settings.clear_color, settings.upscale_ratio)
        current = clip_gradient(current, 1e4, "taa")
        prev_taa = current

    # ---- OVERLAY: NaN -> albedo fallback (src/shaders/overlay.wgsl:42) ----
    image = current
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
        prev_upscaled=prev_upscaled,
        **reservoirs,
    )
    stats = None
    if settings.collect_stats:
        stats = {
            "background_fraction": bg.to(torch.float32).mean(),
            "nonfinite_pixels": nan_mask.to(torch.int32).sum(),
            "mean_luminance_direct": luminance(direct_d).mean(),
            "mean_luminance_emissive": luminance(em_d).mean(),
            "mean_luminance_indirect": luminance(ind_d).mean(),
            "mean_temporal_count": reservoirs["direct_temporal"].count.mean(),
            "mean_reservoir_lifetime": reservoirs["direct_temporal"].lifetime.mean(),
        }

    outputs = RenderOutputs(
        image=image,
        albedo=albedo,
        direct=direct_d,
        emissive=em_d,
        indirect=ind_d,
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
