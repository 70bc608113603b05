"""Render settings: the same frozen dataclasses and constants as
``hikari_tpu.config``, so a settings value reads the same in both
packages.

The dataclass keeps every field of the port's, so a configuration file
builds on either side; ``render/pipeline.check_supported`` refuses the
settings that the reference frame does not follow.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass


class Taa(enum.Enum):
    """Temporal anti-aliasing method (reference src/lib.rs:468-472)."""

    JASMINE = "jasmine"
    NONE = "none"


class UpscaleMode(enum.Enum):
    """Upscaling implementation (reference src/lib.rs:476-513)."""

    FSR1 = "fsr1"
    SMAA_TU4X = "smaa_tu4x"
    NONE = "none"


@dataclass(frozen=True)
class Upscale:
    """Upscale method + ratio; ``ratio`` is clamped to [1, 2] like the
    reference's ``Upscale::ratio`` (src/lib.rs:495-499)."""

    mode: UpscaleMode = UpscaleMode.SMAA_TU4X
    ratio: float = 2.0
    sharpness: float = 0.0

    def clamped_ratio(self) -> float:
        if self.mode == UpscaleMode.NONE:
            return 1.0
        return min(max(self.ratio, 1.0), 2.0)

    @staticmethod
    def smaa_tu4x(ratio: float = 2.0) -> "Upscale":
        return Upscale(mode=UpscaleMode.SMAA_TU4X, ratio=ratio)

    @staticmethod
    def fsr1(ratio: float = 2.0, sharpness: float = 0.0) -> "Upscale":
        return Upscale(mode=UpscaleMode.FSR1, ratio=ratio, sharpness=sharpness)

    @staticmethod
    def none() -> "Upscale":
        return Upscale(mode=UpscaleMode.NONE, ratio=1.0)


@dataclass(frozen=True)
class RenderSettings:
    """Per-camera settings; defaults mirror ``HikariSettings::default``
    (reference src/lib.rs:436-455). ``width``/``height`` are the output
    resolution; the render resolution is ``output // upscale.ratio``."""

    width: int = 512
    height: int = 512

    direct_validate_interval: int = 3
    emissive_validate_interval: int = 5
    max_temporal_reuse_count: int = 50
    max_spatial_reuse_count: int = 800
    max_reservoir_lifetime: float = 100.0
    solar_angle: float = 0.046
    indirect_bounces: int = 1
    max_indirect_luminance: float = 10.0
    clear_color: tuple = (0.4, 0.4, 0.4, 1.0)
    temporal_reuse: bool = True
    emissive_spatial_reuse: bool = False
    indirect_spatial_reuse: bool = True
    denoise: bool = True
    taa: Taa = Taa.JASMINE
    upscale: Upscale = Upscale()

    firefly_filtering: bool = True
    hdr: bool = False
    bloom: bool = False
    bloom_threshold: float = 1.0
    bloom_intensity: float = 0.15
    fxaa: bool = False
    emissive_lit: bool = True

    # Closest-hit search (trace/api.py trace_rays): the reference tests
    # every triangle for "auto", "pallas" and "bruteforce".
    tracer: str = "auto"
    bruteforce_max_tris: int = 2048
    max_traversal_steps: int = 0

    collect_stats: bool = False

    spatial_taps: str = "rolls"
    spatial_tap_variants: int = 4
    spatial_radiance_grads: bool = False

    # Store the cross-frame reservoir state in f16 (positions stay f32),
    # mirroring the reference's 64-byte PackedReservoir (light.wgsl:35-43).
    reservoir_f16: bool = True

    remat: bool = True
    channel_remat: bool = False
    reproject: str = "adaptive"
    stop_after: str | None = None

    def __post_init__(self):
        if isinstance(self.clear_color, list):
            object.__setattr__(self, "clear_color", tuple(self.clear_color))

    @property
    def upscale_ratio(self) -> float:
        return self.upscale.clamped_ratio()

    @property
    def render_size(self) -> tuple:
        """Internal render resolution (height, width) — reference
        ``scaled_size`` (src/light.rs:318-319)."""
        r = self.upscale_ratio
        return (int(self.height / r), int(self.width / r))

    @property
    def output_size(self) -> tuple:
        return (self.height, self.width)

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)


WORKGROUP_SIZE = 8

# Constants from the reference light shader (src/shaders/light.wgsl:226-256).
RAY_BIAS = 0.02
DISTANCE_MAX = 65535.0
NOISE_TEXTURE_COUNT = 16
GOLDEN_RATIO = 1.618033989
POSITION_MISS_THRESHOLD = 0.5
MAX_VARIANCE = 10.0
F32_EPSILON = 1.1920929e-7
F32_MAX = 3.402823466e38

SPATIAL_REUSE_COUNT_DIRECT = 16
SPATIAL_REUSE_RANGE_DIRECT = 20.0
SPATIAL_REUSE_COUNT_EMISSIVE = 8
SPATIAL_REUSE_RANGE_EMISSIVE = 10.0
SPATIAL_REUSE_TAPS = 4
DIRECT_VALIDATION_FRAME_SAMPLE_THRESHOLD = 4
SPATIAL_VARIANCE_SAMPLE_THRESHOLD = 4
