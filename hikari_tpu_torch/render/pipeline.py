"""The frame pipeline — the port of ``hikari_tpu.render.pipeline``:

    outputs, state' = render_frame(scene, camera, state, settings)

The frame goes G-buffer -> albedo -> direct (sun) -> emissive (+ spatial
reuse) -> indirect (+ spatial reuse) -> denoise x3 -> tone mapping ->
SMAA TU4x or FSR1 -> TAA -> overlay (HDR inverse Reinhard, bloom, FXAA,
the NaN -> albedo fallback) (reference render graph PREPASS -> LIGHT ->
POST_PROCESS -> OVERLAY, src/lib.rs:332-365). ``settings.stop_after``
cuts the frame after a stage (``render/stops.py``).

Under ``torch.profiler`` the frame is the range ``render_frame``, and each
pass that runs is one range ``pass:<name>`` inside it, in frame order:
``unpack`` (the f16 reservoirs), ``prepass``, ``albedo``, ``direct_lit``,
``emissive_lit``, ``emissive_spatial``, ``indirect_lit``,
``indirect_spatial``, ``denoise``, ``tonemap``, ``smaa``, ``taa``,
``fsr``, ``overlay`` and ``pack`` (the reservoirs, the next state and the
stats). Every launch of a whole frame falls under exactly one of them.

Under a sharded frame (``parallel/sharding.make_sharded_render``) every
pass runs on the rank's block of the image (``utils.block``). The post
chain's passes (SMAA TU4x, TAA, FSR1, bloom, FXAA) read neighbourhoods,
history and mips that reach anywhere: each runs on the gathered image and
keeps the block's rows.

Where the JAX package fails on a setting (FSR1 under TAA Jasmine, SMAA
TU4x at a fractional ratio, bloom on a mip with an odd side), the port
raises ValueError naming the JAX line instead of rendering a frame the
reference does not define.
"""

from __future__ import annotations

import functools

import torch

from hikari_tpu_torch.config import RenderSettings, Taa, UpscaleMode
from hikari_tpu_torch.diff import clip_gradient
from hikari_tpu_torch.render.bloom import bloom as bloom_pass
from hikari_tpu_torch.render.bloom import mip_sizes
from hikari_tpu_torch.render.camera import Camera
from hikari_tpu_torch.render.denoise import deferred_planes, denoise_channel
from hikari_tpu_torch.render.filters import nearest_sample
from hikari_tpu_torch.render.fsr import fsr_upscale
from hikari_tpu_torch.render.fxaa import fxaa as fxaa_pass
from hikari_tpu_torch.render.gbuffer import render_gbuffer
from hikari_tpu_torch.render.light import direct_lit_pass, full_screen_albedo, indirect_lit_pass
from hikari_tpu_torch.render.noise import blue_noise_bank
from hikari_tpu_torch.render.restir import Reservoir, compress_reservoir, decompress_reservoir
from hikari_tpu_torch.render.smaa import smaa_tu4x
from hikari_tpu_torch.render.spatial import spatial_reuse_pass
from hikari_tpu_torch.render.stops import check_stop, prefix_sum
from hikari_tpu_torch.render.taa import taa_jasmine
from hikari_tpu_torch.render.tonemap import inverse_reinhard_luminance, tone_mapping
from hikari_tpu_torch.render.types import FrameState, GBuffer, RenderOutputs
from hikari_tpu_torch.scene.buffers import SceneBuffers
from hikari_tpu_torch.trace.api import remat
from hikari_tpu_torch.utils import luminance, map_tensors, resolve_device, uv_grid
from hikari_tpu_torch.utils.block import WHOLE
from hikari_tpu_torch.utils.block import current as current_block
from hikari_tpu_torch.utils.profiling import pass_scope

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


def image_size(settings: RenderSettings):
    """(h, w) of the frame's image: twice the render size under SMAA TU4x,
    the output size under FSR1, else the render size."""
    rh, rw = settings.render_size
    if settings.upscale.mode == UpscaleMode.SMAA_TU4X:
        return 2 * rh, 2 * rw
    if settings.upscale.mode == UpscaleMode.FSR1:
        return settings.output_size
    return rh, rw


def check_supported(settings: RenderSettings) -> None:
    """Raise ValueError for a setting neither package defines: a
    ``stop_after`` that is no stop point, bloom on an image whose mip chain
    has an odd side (``render/bloom.py``). The reference faults that a
    frame meets later (FSR1 under TAA Jasmine, SMAA TU4x at a fractional
    ratio) raise where the JAX package fails."""
    check_stop(settings.stop_after)
    if settings.bloom and settings.stop_after is None:
        mip_sizes(image_size(settings))


def _albedo_at_render_res(albedo, settings: RenderSettings, frame_number: int):
    """The full-res albedo at each render pixel's jittered deferred uv
    (denoise.wgsl:148-150)."""
    return deferred_planes((albedo,), settings, frame_number)[0]


def _denoise3(direct, direct_var, em, em_var, ind, ind_var, albedo, gbuffer,
              frame_number: int, settings: RenderSettings, denoise_fn=denoise_channel):
    """The three lighting channels through one denoiser each."""
    albedo_rr = _albedo_at_render_res(albedo, settings, frame_number)
    return tuple(
        denoise_fn(rad, var, albedo_rr, gbuffer, frame_number, settings)
        for rad, var in ((direct, direct_var), (em, em_var), (ind, ind_var))
    )


def _post_gbuffers(gbuffer: GBuffer, prev_gbuffer: GBuffer):
    """(this frame's, the previous frame's) G-buffer as SMAA TU4x and TAA
    read them, whole: under a sharded frame gathered from the blocks, with
    the planes they read (position, velocity/uv, instance) and the others
    None."""
    blk = current_block()
    if not blk.sharded:
        return gbuffer, prev_gbuffer
    return tuple(GBuffer(position=blk.gather(gb.position), normal=None, depth_gradient=None,
                         instance=blk.gather(gb.instance), material=None,
                         velocity_uv=blk.gather(gb.velocity_uv))
                 for gb in (gbuffer, prev_gbuffer))


def _firewall(out, name):
    """Gradient firewall at a pass boundary: every float output passes
    ``clip_gradient`` (identity forward), as in the JAX pipeline."""
    return map_tensors(
        lambda x: clip_gradient(x, 1e4, name) if x.is_floating_point() else x, out
    )


def _pass(settings: RenderSettings, name, fn, *args, **kwargs):
    """One pass, ``fn(*args, **kwargs)``, behind its gradient firewall. With
    ``settings.remat`` and grad enabled the pass is rematerialized
    (``trace.api.remat``: JAX ``pipeline.py`` ``ckpt``): its backward runs
    it again, on the same arguments, instead of keeping its intermediates,
    and replays its hits. It runs under the profiler range ``pass:<name>``."""
    with pass_scope(f"pass:{name}"):
        if settings.remat and torch.is_grad_enabled():
            return _firewall(remat(functools.partial(fn, **kwargs), *args), name)
        return _firewall(fn(*args, **kwargs), name)


def _truncated(state_in: FrameState, device, *trees):
    """A frame cut by ``stop_after`` (JAX ``pipeline.py`` ``_truncate``):
    every output is a (4, 4, 4) image holding the sum of the float leaves
    computed so far (over the whole image: a cross-rank sum under a sharded
    frame), and the input state is carried with its frame number
    advanced."""
    img = torch.zeros((4, 4, 4), device=device) + current_block().sum(prefix_sum(*trees))
    out = RenderOutputs(image=img, albedo=img, direct=img, emissive=img, indirect=img,
                        tonemapped=img, stats=None)
    return out, state_in.replace(frame_number=int(state_in.frame_number) + 1)


def _mirrored_fault(what, where, error):
    return ValueError(
        f"{what}: the JAX package fails here ({where}: {error}), so the port does not define "
        f"this frame"
    )


def render_frame(
    scene: SceneBuffers,
    camera: Camera,
    state: FrameState,
    settings: RenderSettings,
    noise_bank=None,
    denoise_fn=None,
):
    """Render one frame. Returns (RenderOutputs, FrameState).

    ``denoise_fn``: a channel denoiser with the signature of
    ``render/denoise.denoise_channel`` to run instead of it (JAX
    ``render_frame``'s): the sharded frame's halo-exchange denoiser,
    ``parallel/halo.denoise_channel_sharded``. The frame runs under the
    profiler range ``render_frame``."""
    with pass_scope("render_frame"):
        return _frame(scene, camera, state, settings, noise_bank, denoise_fn)


def _frame(scene, camera, state, settings, noise_bank, denoise_fn):
    check_supported(settings)
    dev = scene.device
    blk = current_block()
    if noise_bank is None:
        noise_bank = noise_bank_on(dev)
    frame_number = int(state.frame_number)
    state_in = state
    stop = settings.stop_after or ""

    def cut(*trees):
        return _truncated(state_in, dev, *trees)

    if settings.reservoir_f16:
        with pass_scope("pass:unpack"):
            state = state.replace(
                **{k: decompress_reservoir(getattr(state, k)) for k in _RESERVOIRS})

    gbuffer = _pass(settings, "prepass", render_gbuffer, scene, camera, frame_number, settings)
    if stop == "gbuffer" or stop.startswith("gbuffer:"):
        return cut(gbuffer)
    albedo = _pass(settings, "albedo", full_screen_albedo, scene, camera, gbuffer)
    if stop == "albedo":
        return cut(gbuffer, albedo)

    direct_out, direct_var, direct_temporal, de_spatial, bg, _ = _pass(
        settings, "direct_lit", direct_lit_pass,
        scene, camera, gbuffer, state.direct_temporal, state.de_spatial, noise_bank,
        frame_number, settings, emissive_lit=False, render_emissive=True,
    )
    if stop == "direct" or stop.startswith("direct:"):
        return cut(gbuffer, albedo, direct_out, direct_var, de_spatial)

    rh, rw = blk.size(settings.render_size)
    if settings.emissive_lit and scene.num_emissives > 0:
        em_out, em_var, em_temporal, de_spatial, _, _ = _pass(
            settings, "emissive_lit", direct_lit_pass,
            scene, camera, gbuffer, state.emissive_temporal, de_spatial, noise_bank,
            frame_number, settings, emissive_lit=True, render_emissive=False,
        )
        # "emissive:<stage>" stops inside the emissive pass, before spatial
        # reuse; plain "emissive" after it.
        if stop.startswith("emissive:"):
            return cut(gbuffer, albedo, direct_out, em_out, em_var, de_spatial)
        if settings.emissive_spatial_reuse:
            em_out, em_var, de_spatial = _pass(
                settings, "emissive_spatial", spatial_reuse_pass,
                scene, camera, gbuffer, em_temporal, de_spatial, em_var, frame_number, settings,
                emissive_lit=True,
            )
    else:
        em_out = torch.zeros((rh, rw, 3), device=dev)
        em_var = torch.zeros((rh, rw), device=dev)
        em_temporal = state.emissive_temporal
    if stop == "emissive":
        return cut(gbuffer, albedo, direct_out, em_out, em_var, de_spatial)

    indirect_spatial = state.indirect_spatial
    if settings.indirect_bounces > 0:
        ind_out, ind_var, ind_temporal, indirect_spatial, _, _ = _pass(
            settings, "indirect_lit", indirect_lit_pass,
            scene, camera, gbuffer, state.indirect_temporal, indirect_spatial, noise_bank,
            frame_number, settings,
        )
        if stop.startswith("indirect:"):
            # Before spatial reuse, so the delta prices the channel alone.
            return cut(gbuffer, albedo, direct_out, em_out, ind_out)
        if settings.indirect_spatial_reuse:
            ind_out, ind_var, indirect_spatial = _pass(
                settings, "indirect_spatial", spatial_reuse_pass,
                scene, camera, gbuffer, ind_temporal, indirect_spatial, ind_var, frame_number,
                settings, emissive_lit=False,
            )
    else:
        ind_out = torch.zeros((rh, rw, 3), device=dev)
        ind_var = torch.zeros((rh, rw), device=dev)
        ind_temporal = state.indirect_temporal
    if stop == "indirect" or stop.startswith("indirect:"):
        return cut(gbuffer, albedo, direct_out, em_out, ind_out, ind_var, indirect_spatial)

    # ---- POST PROCESS ----
    if settings.denoise:
        # The reference dispatches one denoise pipeline per channel
        # (post_process.rs:1190); the JAX package vmaps the three, under one
        # remat.
        direct_d, em_d, ind_d = _pass(
            settings, "denoise", _denoise3, direct_out, direct_var, em_out, em_var, ind_out,
            ind_var, albedo, gbuffer, frame_number, settings,
            denoise_fn=denoise_fn or denoise_channel,
        )
    else:
        direct_d, em_d, ind_d = direct_out, em_out, ind_out
    if stop == "denoise":
        return cut(gbuffer, albedo, direct_d, em_d, ind_d)

    # Post-chain gradient firewalls after tone mapping, SMAA and TAA, as in
    # the JAX pipeline.
    with pass_scope("pass:tonemap"):
        fg = (~bg).to(torch.float32)[..., None]

        def with_alpha(rgb):
            return torch.cat([rgb, fg], dim=-1)

        tonemapped = tone_mapping(
            with_alpha(direct_d), with_alpha(em_d) * fg, with_alpha(ind_d) * fg,
            settings.clear_color,
        )
        tonemapped = clip_gradient(tonemapped, 1e4, "tonemap")
    if stop == "tonemap":
        return cut(gbuffer, albedo, tonemapped)

    current = tonemapped
    prev_upscaled = state.prev_upscaled
    smaa = settings.upscale.mode == UpscaleMode.SMAA_TU4X
    taa = settings.taa == Taa.JASMINE
    post_gbuffers = None  # gathered by the first of SMAA and TAA that runs
    if smaa:
        with pass_scope("pass:smaa"):
            if not float(settings.upscale_ratio).is_integer():
                h, w = settings.output_size
                frh, frw = settings.render_size
                raise _mirrored_fault(
                    f"SMAA TU4x at ratio {settings.upscale_ratio}",
                    "hikari_tpu/render/smaa.py:162",
                    f"TypeError: incompatible shapes for broadcasting: ({frh}, {frw}), "
                    f"({h // 2}, {w // 2})",
                )
            post_gbuffers = _post_gbuffers(gbuffer, state.prev_gbuffer)
            current = blk.take(smaa_tu4x(
                blk.gather(current), blk.gather(state.prev_upscaled), *post_gbuffers,
                frame_number, stop=stop.split(":", 1)[1] if stop.startswith("smaa:") else None,
            ))
            current = clip_gradient(current, 1e4, "smaa")
            prev_upscaled = current
    if stop == "smaa" or stop.startswith("smaa:"):
        return cut(gbuffer, albedo, current)

    prev_taa = state.prev_taa
    if taa:
        with pass_scope("pass:taa"):
            if settings.upscale.mode == UpscaleMode.FSR1:
                frh, frw = settings.render_size
                raise _mirrored_fault(
                    "FSR1 under TAA Jasmine", "hikari_tpu/render/taa.py:402, _taa_consume",
                    f"TypeError: incompatible shapes for broadcasting: ({frh}, {frw}), "
                    f"{settings.output_size}: TAA runs at the render size, its previous-depth "
                    f"taps at the G-buffer's",
                )
            post_gbuffers = post_gbuffers or _post_gbuffers(gbuffer, state.prev_gbuffer)
            current = blk.take(taa_jasmine(blk.gather(current), blk.gather(state.prev_taa),
                                           *post_gbuffers, settings.clear_color,
                                           settings.upscale_ratio))
            current = clip_gradient(current, 1e4, "taa")
            prev_taa = current
    if stop == "taa":
        return cut(gbuffer, albedo, current)

    if settings.upscale.mode == UpscaleMode.FSR1:
        with pass_scope("pass:fsr"):
            current = blk.take(fsr_upscale(blk.gather(current), settings.output_size,
                                           settings.upscale.sharpness))

    # ---- OVERLAY: HDR inverse Reinhard (src/shaders/overlay.wgsl:27-46),
    # the chained bloom and FXAA (src/lib.rs:332-365), and the NaN ->
    # albedo fallback (overlay.wgsl:42) ----
    with pass_scope("pass:overlay"):
        image = current
        if settings.hdr:
            image = torch.cat([inverse_reinhard_luminance(image[..., :3]), image[..., 3:4]],
                              dim=-1)
        if settings.bloom:
            image = blk.take(bloom_pass(blk.gather(image), settings.bloom_threshold,
                                        settings.bloom_intensity))
        if settings.fxaa:
            image = blk.take(fxaa_pass(blk.gather(image)))
        nan_mask = torch.isnan(image).any(-1, keepdim=True)
        albedo_out = albedo
        if image.shape[:2] != albedo.shape[:2]:
            full = (image.shape[0] * blk.ny, image.shape[1] * blk.nx)
            albedo_out = blk.take(nearest_sample(blk.gather(albedo), uv_grid(full, dev)))
        image = torch.where(
            nan_mask, torch.cat([albedo_out, torch.ones_like(albedo_out[..., :1])], dim=-1),
            image,
        )

    with pass_scope("pass:pack"):
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
            # Over the whole image: cross-rank sums under a sharded frame.
            stats = {
                "background_fraction": blk.mean(bg.to(torch.float32)),
                "nonfinite_pixels": blk.sum(nan_mask.to(torch.int32).sum()),
                "mean_luminance_direct": blk.mean(luminance(direct_d)),
                "mean_luminance_emissive": blk.mean(luminance(em_d)),
                "mean_luminance_indirect": blk.mean(luminance(ind_d)),
                "mean_temporal_count": blk.mean(reservoirs["direct_temporal"].count),
                "mean_reservoir_lifetime": blk.mean(reservoirs["direct_temporal"].lifetime),
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


def initial_state(settings: RenderSettings, device=None, block=WHOLE) -> FrameState:
    """Allocate the cross-frame state with the per-pass shapes of the JAX
    package's ``initial_state``, on ``device`` (the CUDA card unless the
    caller names another; raises without a card): of the whole image, or
    only of ``block`` of it (``utils.block.Block``; what a rank of a
    sharded frame holds, ``parallel/multihost.host_local_state``)."""
    device = resolve_device(device)
    frh, frw = settings.render_size
    h, w = block.size(settings.output_size)
    rh, rw = block.size((frh, frw))
    smaa = settings.upscale.mode == UpscaleMode.SMAA_TU4X
    taa_hw = block.size((2 * frh, 2 * frw)) if smaa else (rh, rw)

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
        prev_upscaled=torch.zeros(block.size((2 * frh, 2 * frw)) + (4,), device=device),
    )
