"""One configuration file, built by either side: the port (package
``hikari_tpu_torch``) or the reference (``hikari_bench.reference``), which
keep the same scene constructors and settings."""

from __future__ import annotations

import importlib


def build(config: dict, package: str, device):
    """(scene, camera, settings) of ``config`` from ``package``'s own
    ``io.scenes`` and ``config``: the constructor named by ``scene``, the
    geometry named by ``geometry`` where the file gives one, then every
    key of ``settings`` (``upscale`` as ``{"mode", "ratio"}``, ``taa`` by
    the enum's name)."""
    scenes = importlib.import_module(f"{package}.io.scenes")
    cfg = importlib.import_module(f"{package}.config")
    scene, camera, settings = scenes.CONFIGS[config["scene"]](device=device)
    geometry = config.get("geometry")
    if geometry is not None:
        scene = getattr(scenes, geometry["fn"])(**geometry.get("kwargs", {}))
    kw = dict(config["settings"])
    if "upscale" in kw:
        up = kw.pop("upscale")
        kw["upscale"] = getattr(cfg.Upscale, up["mode"])(up["ratio"])
    if "taa" in kw:
        kw["taa"] = cfg.Taa[kw["taa"]]
    return scene, camera, settings.replace(**kw)
