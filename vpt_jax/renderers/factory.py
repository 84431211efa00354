"""Renderer registry — string → renderer, mirroring RendererFactory.js:10-23."""

from __future__ import annotations

from . import base, depth, dos, eam, iso, lao, mcm, mcs, mip

MODULES = {
    "mip": mip,
    "iso": iso,
    "eam": eam,
    "dos": dos,
    "lao": lao,
    "mcs": mcs,
    "mcm": mcm,
    "depth": depth,
}

#: Measured ms per progressive frame at 512² with default params on a
#: 256³ blobs volume, fast path (bf16 tables, one-hot TF, auto tracking) —
#: interactivity honesty for the viewer/CLI (chip_smoke.py renderers
#: phase on the card below).
FRAME_COST_DEVICE = "NVIDIA H100 80GB HBM3 at a 400 W power limit"
FRAME_COST_MS_512 = {
    "mcm": 2.68, "mcs": 4.73, "iso": 10.03, "mip": 10.43, "depth": 10.76,
    "dos": 10.88, "eam": 11.05, "lao": 14.56,
}


def get_module(key: str):
    if key not in MODULES:
        raise ValueError(
            f"unknown renderer {key!r}; available: {sorted(MODULES)}")
    return MODULES[key]


def make_renderer(key: str, params=None, height: int = 512,
                  width: int = 512) -> base.Renderer:
    module = get_module(key)

    cls = type(f"{key.upper()}Renderer", (base.Renderer,), {
        "module": module,
        "Params": module.Params,
    })
    return cls(params=params, height=height, width=width)
