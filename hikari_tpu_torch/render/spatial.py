"""ReSTIR spatial reuse — the port of ``hikari_tpu.render.spatial``
(reference ``spatial_reuse`` kernel, src/shaders/light.wgsl:1500-1684):
merge the pixel's fresh temporal reservoir into the reprojected running
spatial reservoir, then take 16 (emissive: 8) neighbour taps on a
Fibonacci spiral, rejecting by depth ratio, normal agreement, backface and
a screen-space depth ray-march occlusion test, and merging the survivors
with the GRIS reconnection Jacobian.

Both tap forms of the JAX package are ported, selected by
``RenderSettings.spatial_taps``:

* ``"rolls"`` (the default, what the JAX frames run): K globally rotated
  copies of the spiral; each pixel takes one variant per frame, so every
  neighbour of a variant sits at one integer offset. The JAX package
  fetches each variant with a wrapping roll and picks per pixel; here each
  pixel fetches its own variant's texels with one wrapping gather, which
  gives the same values.
* any other value: the reference's per-pixel rotated spiral with
  per-pixel gathers.

The TPU-only unrolled loop (``_spatial_unroll``) is not ported: it gives
the same math. The reuse loop works on detached reservoirs (the selection
is estimator machinery); gradients reach the materials through the final
shade.

The rolled tap loop is ``spatial_taps``: on CUDA tensors one launch of the
hand-written kernel ``csrc/spatial_reuse.cu`` (one thread a pixel, every
tap in registers, the spiral's tables passed by value: no host sync), on
CPU tensors its plain twin ``spatial_taps_reference``, the loop of
``rolled_tap`` in ATen ops. It returns the index of the neighbour whose
sample each pixel took, so that ``spatial_radiance_grads`` rebuilds the
radiance under autograd with one gather.
"""

from __future__ import annotations

import ctypes
import math
import time
from contextlib import contextmanager
from dataclasses import dataclass, replace
from pathlib import Path

import numpy as np
import torch

from hikari_tpu_torch.config import (
    F32_EPSILON,
    GOLDEN_RATIO,
    MAX_VARIANCE,
    SPATIAL_REUSE_COUNT_DIRECT,
    SPATIAL_REUSE_COUNT_EMISSIVE,
    SPATIAL_REUSE_RANGE_DIRECT,
    SPATIAL_REUSE_RANGE_EMISSIVE,
    SPATIAL_REUSE_TAPS,
    SPATIAL_VARIANCE_SAMPLE_THRESHOLD,
    RenderSettings,
)
from hikari_tpu_torch.render.brdf import (
    Surface,
    calculate_view,
    retrieve_surface,
    shading,
    shading_factors,
)
from hikari_tpu_torch.render.camera import Camera
from hikari_tpu_torch.render.light import (
    _render_uv,
    fetch_gbuffer_deferred,
    gather_reservoir,
    jittered_deferred_uv,
    load_previous_reservoir,
    render_coords,
    uv_to_coords,
)
from hikari_tpu_torch.render.restir import (
    Reservoir,
    Sample,
    clamp_reservoir,
    compute_jacobian,
    merge_reservoir,
    merge_reservoir_taken,
    reservoir_variance,
)
from hikari_tpu_torch.render.types import GBuffer
from hikari_tpu_torch.scene.buffers import SceneBuffers
from hikari_tpu_torch.utils import (
    TAU,
    dot3,
    fract,
    luminance,
    map_tensors,
    random_float,
    safe_normalize,
    take_rows,
)
from hikari_tpu_torch.utils.block import current
from hikari_tpu_torch.utils.nvcc import build_library, check_kernel_arg
from hikari_tpu_torch.utils.profiling import host_read

_f32 = np.float32

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "spatial_reuse.cu"
# The kernel's limits (csrc/spatial_reuse.cu): taps a pass, variants of the
# spiral, march taps of one tap.
MAX_TAPS = 16
MAX_VARIANTS = 8
MAX_MARCH = SPATIAL_REUSE_TAPS + 1

# Kernel launches made by ``spatial_taps`` (one per call on CUDA tensors).
launches = 0
# ``spatial_reuse_pass`` calls on a CUDA device. Under ``spatial_taps =
# "rolls"`` each launches the kernel once, so a run can check that every
# spatial pass went through it.
passes = 0
_lib = None
# ptxas report of the last build (registers, shared memory, spills).
build_log = ""


def _spiral_radius(i: int, reuse_count: int, reuse_range: float):
    """Tap i's spiral radius, ray-march interval and tap count, in float32
    as the JAX package computes them."""
    radius = np.sqrt(_f32(i) / _f32(reuse_count)) * _f32(reuse_range)
    interval = max(_f32(1.0), radius / _f32(SPATIAL_REUSE_TAPS + 1))
    return radius, interval, int(radius / interval)


def _march_fraction(j: int, tap_count: int) -> float:
    """j / (tap_count + 1) in float32: where the j-th occlusion tap sits
    between the pixel's depth and the sample's."""
    return float(_f32(j) / (_f32(tap_count) + _f32(1.0)))


@dataclass(frozen=True)
class Spiral:
    """The rolled spiral of one pass: ``count`` taps out to ``radius``
    pixels, in ``variants`` copies each turned by 1/variants of a turn, at
    the frame's phase (``random_float(frame_number)``)."""

    count: int
    radius: float
    variants: int
    phase: float

    def tap(self, i: int):
        """Tap i's integer offset (oy, ox) under each variant, its march
        offsets [(ty, tx), ...] under each variant, and its march tap count,
        in float32 as the JAX package's rolls compute them."""
        radius, interval, tap_count = _spiral_radius(i, self.count, self.radius)
        K = _f32(self.variants)
        turn = _f32(i) * _f32(GOLDEN_RATIO)
        phase = _f32(self.phase)
        fs = [interval * _f32(j) / max(radius, _f32(1e-8))
              for j in range(1, min(tap_count, SPATIAL_REUSE_TAPS + 1) + 1)]
        offs, march = [], []
        for k in range(self.variants):
            a = turn + (_f32(k) + phase) / K
            ang = _f32(TAU) * (a - np.floor(a))
            ox, oy = radius * np.cos(ang), radius * np.sin(ang)
            offs.append((math.floor(oy), math.floor(ox)))
            march.append([(math.floor(oy * f), math.floor(ox * f)) for f in fs])
        return offs, march, tap_count


@dataclass(frozen=True)
class Shade:
    """The indirect channel's target: the luminance of ``shading`` at the
    pixel's view vector and surface (the emissive channel's is the
    radiance's luminance: no Shade)."""

    view: torch.Tensor
    surface: Surface
    ambient_color: torch.Tensor


def _target_p(sample: Sample, direction, normal, shade: Shade | None):
    if shade is None:
        p = luminance(sample.radiance[..., :3])
    else:
        p = luminance(shading(shade.view, normal, direction, shade.surface, sample.radiance,
                              shade.ambient_color))
    return p.detach()  # resampling weights are estimator machinery


def _eval_tap(r, q, sample_depth, in_bounds, occluded, depth, s: Sample, shade):
    """Rejection + GRIS-Jacobian merge of one neighbour candidate
    (light.wgsl:1576-1642) at pixels whose temporal sample is ``s``:
    (reservoir, where it took q's sample)."""
    depth_ratio = depth / torch.where(sample_depth == 0.0, 1e-8, sample_depth)
    ok = in_bounds & (depth_ratio >= 0.9) & (depth_ratio <= 1.1)
    ok = ok & (q.count >= F32_EPSILON)
    ok = ok & (dot3(s.visible_normal, q.s.visible_normal) >= 0.866)
    sample_direction = safe_normalize(q.s.sample_position[..., :3] - s.visible_position[..., :3])
    ok = ok & (dot3(sample_direction, s.visible_normal) >= 0.0)
    ok = ok & ~occluded
    jac = torch.where(q.s.sample_position[..., 3] > 0.5, compute_jacobian(q.s, s), 1.0)
    p = _target_p(q.s, sample_direction, s.visible_normal, shade) / jac
    return merge_reservoir_taken(r, q, p, mask=ok)


def spatial_taps_reference(r: Reservoir, s: Sample, depth, variant, grid: Reservoir,
                           grid_depth, spiral: Spiral, shade: Shade | None, origin):
    """The plain twin of the kernel: the rolled tap loop. ``r``: the
    block's running reservoir (lh, lw) after the self-merge; ``s``: the
    pixels' own temporal sample (its visible position (lh, lw, 4) and
    normal (lh, lw, 3) are read); ``depth`` (lh, lw): the
    G-buffer depth; ``variant`` (lh, lw) i32: the pixel's spiral copy at
    tap 0; ``grid`` and ``grid_depth``: the whole image's (rh, rw)
    temporal grid and depth, as gathered; ``origin``: the block's first
    (row, column). Tap i takes variant (variant + i) mod K, whose integer
    offset wraps around the image, so a wrapping fetch gives what the JAX
    package's roll of that variant gives. Returns (reservoir, winner (lh,
    lw) i32: -1 where ``r`` kept its sample, else the row-major index in
    ``grid`` of the last neighbour whose sample was taken), on detached
    reservoirs."""
    r, grid = (map_tensors(lambda x: x.detach(), x) for x in (r, grid))
    rh, rw = grid_depth.shape
    lh, lw = depth.shape
    dev = depth.device
    y0, x0 = origin
    ys, xs = torch.meshgrid(torch.arange(y0, y0 + lh, dtype=torch.int32, device=dev),
                            torch.arange(x0, x0 + lw, dtype=torch.int32, device=dev),
                            indexing="ij")
    winner = torch.full((lh, lw), -1, dtype=torch.int32, device=dev)
    for i in range(1, spiral.count + 1):
        offs, march, tap_count = spiral.tap(i)
        v = torch.remainder(variant + i, spiral.variants).long()

        def at(table):
            t = host_read("spatial_taps",
                          lambda: torch.tensor(table, dtype=torch.int64, device=dev))
            t = t[v]  # (lh, lw, 2)
            return t[..., 0], t[..., 1]

        oy, ox = at(offs)
        yy, xx = torch.remainder(ys + oy, rh), torch.remainder(xs + ox, rw)
        q = gather_reservoir(grid, yy, xx)
        sample_depth = grid_depth[yy, xx]
        in_bounds = (xs + ox >= 0) & (xs + ox < rw) & (ys + oy >= 0) & (ys + oy < rh)
        occluded = torch.zeros((lh, lw), dtype=torch.bool, device=dev)
        for j in range(len(march[0])):
            ty, tx = at([m[j] for m in march])
            tap_depth = grid_depth[torch.remainder(ys + ty, rh), torch.remainder(xs + tx, rw)]
            ref_depth = depth + (sample_depth - depth) * _march_fraction(j + 1, tap_count)
            occluded = occluded | (tap_depth > ref_depth + 1e-5)
        r, taken = _eval_tap(r, q, sample_depth, in_bounds, occluded, depth, s, shade)
        winner = torch.where(taken, (yy * rw + xx).to(torch.int32), winner)
    return r, winner


class _Reservoir(ctypes.Structure):
    """``SpatialReservoir``: a pointer a field (null where unused)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "radiance", "random", "visible_position", "visible_normal", "visible_instance",
        "sample_position", "sample_normal", "count", "w", "w_sum", "w2_sum")]


class _Pixels(ctypes.Structure):
    """``SpatialPixels``: the block's own planes."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "depth", "position", "normal", "variant", "view", "f0", "diffuse", "roughness", "nov",
        "f90", "ambient")]


class SpatialTaps(ctypes.Structure):
    """``SpatialTaps``: the spiral of one pass, passed to the kernel by
    value."""

    _fields_ = [
        ("taps", ctypes.c_int),
        ("variants", ctypes.c_int),
        ("emissive", ctypes.c_int),
        ("march_count", ctypes.c_int * MAX_TAPS),
        ("march_frac", (ctypes.c_float * MAX_MARCH) * MAX_TAPS),
        ("offset", ((ctypes.c_int8 * 2) * MAX_VARIANTS) * MAX_TAPS),
        ("march", (((ctypes.c_int8 * 2) * MAX_MARCH) * MAX_VARIANTS) * MAX_TAPS),
    ]


class _Frame(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in ("rh", "rw", "y0", "x0", "lh", "lw")]


def pack_spiral(spiral: Spiral, emissive: bool) -> SpatialTaps:
    """The kernel's by-value table of ``spiral``: every tap's offset and
    march offsets under every variant, and its march fractions, exactly as
    ``spatial_taps_reference`` uploads them."""
    if not 0 < spiral.count <= MAX_TAPS or not 0 < spiral.variants <= MAX_VARIANTS:
        raise ValueError(f"spatial_taps: the kernel takes 1-{MAX_TAPS} taps and 1-{MAX_VARIANTS} "
                         f"variants, got {spiral.count} and {spiral.variants}")
    t = SpatialTaps(taps=spiral.count, variants=spiral.variants, emissive=int(emissive))
    offset, march_offset, march_frac, march_count = (
        np.ctypeslib.as_array(x) for x in (t.offset, t.march, t.march_frac, t.march_count))
    K = spiral.variants
    for i in range(1, spiral.count + 1):
        offs, march, tap_count = spiral.tap(i)
        m = len(march[0])
        if m > MAX_MARCH:
            raise ValueError(f"spatial_taps: tap {i} marches {m} taps, the kernel {MAX_MARCH}")
        offs, march = np.asarray(offs), np.asarray(march).reshape(K, m, 2)
        if max(np.abs(offs).max(), np.abs(march).max(initial=0)) > 127:
            raise ValueError(f"spatial_taps: tap {i} reaches past 127 pixels")
        offset[i - 1, :K] = offs
        march_offset[i - 1, :K, :m] = march
        march_frac[i - 1, :m] = [_march_fraction(j + 1, tap_count) for j in range(m)]
        march_count[i - 1] = m
    return t


def build() -> float:
    """Compile (if needed) and load the kernel library; returns the
    seconds spent. Raises if nvcc is missing or the build fails."""
    global _lib, build_log
    if _lib is not None:
        return 0.0
    start = time.perf_counter()
    lib, build_log = build_library(SOURCE)
    lib.hikari_spatial_taps_bytes.restype = ctypes.c_int
    if lib.hikari_spatial_taps_bytes() != ctypes.sizeof(SpatialTaps):
        raise RuntimeError(f"spatial_taps: the kernel's table is {lib.hikari_spatial_taps_bytes()} "
                           f"bytes, SpatialTaps {ctypes.sizeof(SpatialTaps)}")
    ptr = ctypes.c_void_p
    lib.hikari_spatial_reuse.argtypes = [_Reservoir, _Reservoir, ptr, _Pixels, SpatialTaps,
                                         _Frame, _Reservoir, ptr, ptr]
    lib.hikari_spatial_reuse.restype = ctypes.c_int
    lib.hikari_spatial_reuse_error_string.argtypes = [ctypes.c_int]
    lib.hikari_spatial_reuse_error_string.restype = ctypes.c_char_p
    _lib = lib
    return time.perf_counter() - start


# Channels of each Reservoir field the kernel reads or writes.
_CHANNELS = {"radiance": 4, "random": 4, "visible_position": 4, "visible_normal": 3,
             "visible_instance": 1, "sample_position": 4, "sample_normal": 3, "count": 1,
             "w": 1, "w_sum": 1, "w2_sum": 1}
_READ_R = ("radiance", "random", "visible_position", "visible_normal", "visible_instance",
           "sample_position", "sample_normal", "count", "w_sum", "w2_sum")
_READ_GRID = ("radiance", "random", "visible_position", "visible_normal", "visible_instance",
              "sample_position", "sample_normal", "count", "w")


def _field(r: Reservoir, name: str):
    return getattr(r.s, name) if hasattr(r.s, name) else getattr(r, name)


def _plane(name, x, size, channels, dtype, device):
    shape = tuple(size) + ((channels,) if channels > 1 else ())
    check_kernel_arg("spatial_taps", name, x, dtype, shape, device)
    return x


def _pointers(r: Reservoir, names, size, device, prefix) -> _Reservoir:
    ptrs = _Reservoir()
    for name in names:
        dtype = torch.int32 if name == "visible_instance" else torch.float32
        x = _plane(f"{prefix}.{name}", _field(r, name), size, _CHANNELS[name], dtype, device)
        setattr(ptrs, name, x.data_ptr())
    return ptrs


def bound_bytes(lh: int, lw: int, rh: int, rw: int, emissive: bool) -> int:
    """The bytes the kernel must move, each once: the running reservoir's
    fields it reads and the block's own planes, the gathered grid's fields
    and depth, the new fields and the winner written."""
    r_in = sum(_CHANNELS[n] for n in _READ_R)
    pixels = 9 + (0 if emissive else 15)  # depth, position, normal, variant; view .. ambient
    grid = sum(_CHANNELS[n] for n in _READ_GRID) + 1
    written = r_in + 1
    return 4 * (lh * lw * (r_in + pixels + written) + rh * rw * grid)


# The argument names of ``spatial_taps`` and its twin, in order.
TAP_ARGS = ("r", "s", "depth", "variant", "grid", "grid_depth", "spiral", "shade", "origin")


@dataclass(frozen=True)
class Launch:
    """One launch of the kernel: its C entry's arguments but the stream,
    and the outputs and the BRDF factors they point at (kept alive with
    them, so the launch can be made again)."""

    args: tuple
    out: Reservoir
    winner: torch.Tensor
    factors: tuple = ()

    def __call__(self):
        """Launch on the current stream; returns (reservoir, winner)."""
        global launches
        dev = self.winner.device
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = _lib.hikari_spatial_reuse(*self.args, stream)
        if err:
            msg = _lib.hikari_spatial_reuse_error_string(err).decode()
            raise RuntimeError(f"spatial_taps kernel launch failed: {msg}")
        launches += 1
        return self.out, self.winner


def prepare(r: Reservoir, s: Sample, depth, variant, grid: Reservoir, grid_depth,
            spiral: Spiral, shade: Shade | None, origin) -> Launch:
    """The kernel's launch for a ``spatial_taps`` call, its outputs
    allocated; raises on what the kernel does not take: every plane
    contiguous, f32 (the instance ids and the variant i32), on one CUDA
    device."""
    dev = depth.device
    if depth.dim() != 2 or grid_depth.dim() != 2:
        raise ValueError("spatial_taps: depth and grid_depth must be (h, w) planes")
    lh, lw = depth.shape
    rh, rw = grid_depth.shape
    y0, x0 = origin
    if not (0 <= y0 and y0 + lh <= rh and 0 <= x0 and x0 + lw <= rw):
        raise ValueError(f"spatial_taps: a {lh}x{lw} block at {origin} is outside {rh}x{rw}")
    if rh * rw * 4 >= 2**31:
        raise ValueError("spatial_taps: too many pixels for the kernel's indexing")
    f32 = torch.float32
    taps = pack_spiral(spiral, shade is None)
    r_ptrs = _pointers(r, _READ_R, (lh, lw), dev, "r")
    grid_ptrs = _pointers(grid, _READ_GRID, (rh, rw), dev, "grid")
    px = _Pixels(
        depth=_plane("depth", depth, (lh, lw), 1, f32, dev).data_ptr(),
        position=_plane("s.visible_position", s.visible_position, (lh, lw), 4, f32,
                        dev).data_ptr(),
        normal=_plane("s.visible_normal", s.visible_normal, (lh, lw), 3, f32, dev).data_ptr(),
        variant=_plane("variant", variant, (lh, lw), 1, torch.int32, dev).data_ptr(),
    )
    _plane("grid_depth", grid_depth, (rh, rw), 1, f32, dev)
    factors = ()
    if shade is not None:
        with torch.no_grad():
            factors = f0, diffuse, nov, f90, ambient = shading_factors(
                shade.view, s.visible_normal, shade.surface, shade.ambient_color)
        for name, x, c in (("view", shade.view, 3), ("f0", f0, 3), ("diffuse", diffuse, 3),
                           ("roughness", shade.surface.roughness, 1), ("nov", nov, 1),
                           ("f90", f90, 1), ("ambient", ambient, 3)):
            setattr(px, name, _plane(name, x, (lh, lw), c, f32, dev).data_ptr())
    if dev.type != "cuda":
        raise NotImplementedError(f"spatial_taps: no kernel for device {dev}")
    build()

    def empty(c, dtype=f32):
        return torch.empty((lh, lw) + ((c,) if c > 1 else ()), dtype=dtype, device=dev)

    out = Reservoir(
        s=Sample(radiance=empty(4), random=empty(4), visible_position=empty(4),
                 visible_normal=empty(3), visible_instance=empty(1, torch.int32),
                 sample_position=empty(4), sample_normal=empty(3)),
        count=empty(1), lifetime=r.lifetime.detach(), w=r.w.detach(), w_sum=empty(1),
        w2_sum=empty(1),
    )
    out_ptrs = _Reservoir()
    for name in _READ_R:
        setattr(out_ptrs, name, _field(out, name).data_ptr())
    winner = empty(1, torch.int32)
    frame = _Frame(rh=rh, rw=rw, y0=y0, x0=x0, lh=lh, lw=lw)
    return Launch((r_ptrs, grid_ptrs, grid_depth.data_ptr(), px, taps, frame, out_ptrs,
                   winner.data_ptr()), out, winner, factors)


def spatial_taps(r: Reservoir, s: Sample, depth, variant, grid: Reservoir, grid_depth,
                 spiral: Spiral, shade: Shade | None, origin):
    """``spatial_taps_reference``'s (reservoir, winner), on detached
    reservoirs: CPU tensors run the twin; CUDA tensors launch
    ``csrc/spatial_reuse.cu`` once (``prepare``) or raise."""
    if depth.device.type == "cpu":
        return spatial_taps_reference(r, s, depth, variant, grid, grid_depth, spiral, shade,
                                      origin)
    return prepare(r, s, depth, variant, grid, grid_depth, spiral, shade, origin)()


@contextmanager
def recording():
    """Inside, every ``spatial_taps`` call that ``spatial_reuse_pass``
    makes is appended to the yielded list, as a dict of its arguments by
    name, so that the calls of real frames can be replayed."""
    global spatial_taps
    calls, real = [], spatial_taps

    def record(*args):
        calls.append(dict(zip(TAP_ARGS, args)))
        return real(*args)

    spatial_taps = record
    try:
        yield calls
    finally:
        spatial_taps = real


def spatial_reuse_pass(
    scene: SceneBuffers,
    camera: Camera,
    gbuffer: GBuffer,
    temporal: Reservoir,
    spatial_prev: Reservoir,
    variance_in,
    frame_number: int,
    settings: RenderSettings,
    emissive_lit: bool,
):
    """``temporal``: this channel's freshly written temporal grid;
    ``spatial_prev``: the previous frame's spatial grid (reprojected here);
    ``variance_in`` (rh, rw): the temporal pass's variance. Returns
    (radiance (rh, rw, 3), variance, new spatial reservoir grid).

    Under a sharded frame the pass computes its block's pixels and reads
    the taps, which reach any pixel (the spiral wraps around the image),
    from the gathered temporal grid and depths."""
    global passes
    render_size = settings.render_size
    deferred_size = settings.output_size
    ratio = settings.upscale_ratio
    rh, rw = render_size
    blk = current()
    lh, lw = blk.size(render_size)
    dev = gbuffer.position.device
    if dev.type == "cuda":
        passes += 1

    reuse_count = SPATIAL_REUSE_COUNT_EMISSIVE if emissive_lit else SPATIAL_REUSE_COUNT_DIRECT
    reuse_range = SPATIAL_REUSE_RANGE_EMISSIVE if emissive_lit else SPATIAL_REUSE_RANGE_DIRECT

    ys, xs = render_coords(render_size, dev)
    uv = _render_uv(render_size, dev)
    duv = jittered_deferred_uv(uv, frame_number, deferred_size, ratio)
    g = fetch_gbuffer_deferred(gbuffer, frame_number, settings)
    depth = g.position[..., 3].contiguous()
    background = depth < F32_EPSILON
    position = g.position[..., :3]

    def detach(r):
        det = map_tensors(lambda x: x.detach(), r)
        if not settings.spatial_radiance_grads:
            return det
        return replace(det, s=replace(det.s, radiance=r.s.radiance))

    temporal = detach(temporal)
    spatial_prev = detach(spatial_prev)
    temporal_all = map_tensors(blk.gather, temporal)
    depth_all = blk.gather(depth)
    gdepth_all = blk.gather(gbuffer.position[..., 3])

    r = temporal  # load_reservoir(coords), light.wgsl:1520
    q0 = r
    s = q0.s
    use_spatial_variance = r.count <= SPATIAL_VARIANCE_SAMPLE_THRESHOLD
    previous_uv = duv - g.velocity_uv[..., :2]

    max_lifetime = (
        float("inf") if settings.max_reservoir_lifetime <= 1.0 else settings.max_reservoir_lifetime
    )
    use_prev = r.lifetime <= max_lifetime
    r_prev = load_previous_reservoir(spatial_prev, previous_uv, render_size)
    r = r_prev.select(use_prev, r)

    surface = retrieve_surface(scene, g.material, g.velocity_uv[..., 2:4])
    view = calculate_view(camera.position, position)
    shade = None if emissive_lit else Shade(view, surface, scene.ambient_color)

    self_dir = safe_normalize(s.sample_position[..., :3] - s.visible_position[..., :3])
    r = merge_reservoir(r, q0, _target_p(q0.s, self_dir, s.visible_normal, shade))
    r = replace(r, s=replace(r.s, visible_position=s.visible_position,
                             visible_normal=s.visible_normal))

    frame_phase = float(random_float(frame_number))
    rot = fract(s.random.sum(-1) + frame_phase)
    wh = host_read("spatial_size", lambda: torch.tensor([rw, rh], dtype=torch.float32, device=dev))

    def pixel_tap(i, r):
        """The reference's per-pixel rotated spiral (light.wgsl:1566-1628)."""
        radius, interval, tap_count = _spiral_radius(i, reuse_count, reuse_range)
        angle = TAU * fract(float(_f32(i) * _f32(GOLDEN_RATIO)) + rot)
        offset = float(radius) * torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1)
        coords = torch.stack([xs.to(torch.float32), ys.to(torch.float32)], dim=-1)
        sample_coords = (offset + coords).to(torch.int32)
        sample_uv = (sample_coords.to(torch.float32) + 0.5) / wh
        in_bounds = ((sample_uv >= 0.0) & (sample_uv <= 1.0)).all(-1)
        sx = torch.clamp(sample_coords[..., 0], 0, rw - 1)
        sy = torch.clamp(sample_coords[..., 1], 0, rh - 1)
        s_duv = jittered_deferred_uv(sample_uv, frame_number, deferred_size, ratio)
        sdy, sdx = uv_to_coords(s_duv, deferred_size)
        sample_depth = gdepth_all[sdy.long(), sdx.long()]
        q = gather_reservoir(temporal_all, sy, sx)

        occluded = torch.zeros((lh, lw), dtype=torch.bool, device=dev)
        offset_dir = offset / float(max(radius, _f32(1e-8)))
        for j in range(1, min(tap_count, SPATIAL_REUSE_TAPS + 1) + 1):
            tap_dist = float(_f32(j) * interval)
            tap_uv = uv + tap_dist * offset_dir / wh
            tdy, tdx = uv_to_coords(jittered_deferred_uv(tap_uv, frame_number, deferred_size, ratio),
                                    deferred_size)
            tap_depth = gdepth_all[tdy.long(), tdx.long()]
            ref_depth = depth + (sample_depth - depth) * _march_fraction(j, tap_count)
            occluded = occluded | (tap_depth > ref_depth + 1e-5)
        return _eval_tap(r, q, sample_depth, in_bounds, occluded, depth, s, shade)[0]

    if settings.spatial_taps == "rolls":
        K = settings.spatial_tap_variants
        variant = torch.clamp((rot * K).to(torch.int32), max=K - 1)
        planes = map_tensors(lambda x: x.contiguous(), r)
        s_planes = replace(s, visible_position=s.visible_position.contiguous(),
                           visible_normal=s.visible_normal.contiguous())
        r_in = r
        r, winner = spatial_taps(planes, s_planes, depth, variant,
                                 map_tensors(lambda x: x.contiguous(), temporal_all), depth_all,
                                 Spiral(reuse_count, reuse_range, K, frame_phase), shade,
                                 blk.origin(render_size))
        if settings.spatial_radiance_grads:
            # The taken sample's radiance under autograd: the one gather
            # the twin's selects reduce to.
            taken = take_rows(temporal_all.s.radiance.reshape(rh * rw, 4), winner.clamp(min=0))
            radiance = torch.where((winner < 0)[..., None], r_in.s.radiance, taken)
            r = replace(r, s=replace(r.s, radiance=radiance))
    else:
        for i in range(1, reuse_count + 1):
            r = pixel_tap(i, r)

    r = clamp_reservoir(r, settings.max_spatial_reuse_count)

    out_dir = safe_normalize(r.s.sample_position[..., :3] - s.visible_position[..., :3])
    out_radiance = shading(view, s.visible_normal, out_dir, surface, r.s.radiance,
                           scene.ambient_color)
    if emissive_lit:
        total_lum = r.count * luminance(r.s.radiance[..., :3])
    else:
        total_lum = r.count * luminance(out_radiance)
    w = torch.where(total_lum > 0.0, r.w_sum / torch.where(total_lum == 0.0, 1.0, total_lum), 0.0)
    r = replace(r, w=w, lifetime=r.lifetime + 1.0)

    variance = torch.where(use_spatial_variance, reservoir_variance(r, MAX_VARIANCE), variance_in)

    # Background: keep the temporal (empty) reservoir, zero output
    # (light.wgsl:1526-1530).
    r = temporal.select(background, r)
    out = torch.where(background[..., None], 0.0, out_radiance * r.w[..., None])
    variance = torch.where(background, 0.0, variance)
    return out, variance, r
