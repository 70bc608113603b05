"""One configuration file, built by either side: the port (package
``hikari_tpu_torch``) or the reference (``hikari_bench.reference``), which
keep the same scene constructors and settings."""

from __future__ import annotations

import importlib

REFERENCE = "hikari_bench.reference"


def build(config: dict, package: str, device):
    """(scene, camera, settings) of ``config`` from ``package``'s own
    ``io.scenes`` and ``config``: the constructor named by ``scene``, the
    geometry named by ``geometry`` where the file gives one, then every
    key of ``settings`` (``upscale`` as ``{"mode", "ratio"}``, ``taa`` by
    the enum's name).

    The reference takes its constructor from the module the file names
    under ``reference_scene`` (``{"module", "fn"}``) where it names one,
    and the geometry from that module too: a configuration whose scene the
    reference's ``io.scenes`` lacks brings it in a file of its own, under
    ``hikari_bench.reference``; a module elsewhere is refused, so that the
    reference never builds its scene from the program's code."""
    scenes = importlib.import_module(f"{package}.io.scenes")
    cfg = importlib.import_module(f"{package}.config")
    own = config.get("reference_scene") if package == REFERENCE else None
    if own is None:
        make = scenes.CONFIGS[config["scene"]]
    else:
        if not own["module"].startswith(f"{REFERENCE}."):
            raise ValueError(f"reference_scene {own['module']!r} lies outside {REFERENCE}")
        scenes = importlib.import_module(own["module"])
        make = getattr(scenes, own["fn"])
    scene, camera, settings = make(device=device)
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
