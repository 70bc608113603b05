"""The frame pipeline: G-buffer, lighting passes with ReSTIR, tone
mapping (port of ``hikari_tpu.render``)."""

from hikari_bench.reference.render.camera import Camera
from hikari_bench.reference.render.pipeline import initial_state, render_frame
from hikari_bench.reference.render.types import FrameState, GBuffer, RenderOutputs

__all__ = ["Camera", "FrameState", "GBuffer", "RenderOutputs", "initial_state", "render_frame"]
