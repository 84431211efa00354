"""Command-line interface.

The reference exposes every renderer/tone-mapper parameter through
declarative PropertyBag schemas that auto-build its settings dialogs
(``PropertyBag.js:9-15`` → ``DialogConstructor.js:22-34``).  Here the same
role is played by the renderer Params dataclasses: their fields are
introspected into CLI flags (``--mcm-extinction``, ``--iso-isovalue``, …),
so the full parameter surface is scriptable.

Subcommands:
  render   — progressive render of a volume to PNG (sample-counted)
  animate  — orbit/circle animation to a PNG sequence
  fit      — inverse rendering: fit voxel densities to a target image
  serve    — static file server with HTTP Range support (BVP streaming)
  info     — list renderers / tone mappers / parameters
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time


def _add_params_args(parser, key, params_cls):
    for f in dataclasses.fields(params_cls):
        name = f"--{key}-{f.name.replace('_', '-')}"
        default = f.default if f.default is not dataclasses.MISSING else None
        if isinstance(default, bool):
            parser.add_argument(name, type=lambda s: s.lower() in
                                ("1", "true", "yes"), default=None,
                                metavar="BOOL")
        elif isinstance(default, int):
            parser.add_argument(name, type=int, default=None)
        elif isinstance(default, float):
            parser.add_argument(name, type=float, default=None)
        elif isinstance(default, tuple):
            parser.add_argument(name, type=lambda s: tuple(
                float(x) for x in s.split(",")), default=None,
                metavar="X,Y,Z")


def _collect_params(args, key, params_cls):
    kwargs = {}
    for f in dataclasses.fields(params_cls):
        attr = f"{key}_{f.name}"
        val = getattr(args, attr, None)
        if val is not None:
            kwargs[f.name] = val
    return params_cls(**kwargs) if kwargs else params_cls()


def _load_volume(args):
    import numpy as np

    from . import volume as vol_mod
    from .io import readers

    spec = args.volume
    if spec.startswith("sphere:"):
        return vol_mod.sphere_volume(int(spec.split(":")[1]))
    if spec.startswith("shell:"):
        return vol_mod.shell_volume(int(spec.split(":")[1]))
    if spec.startswith("blobs:"):
        return vol_mod.blobs_volume(int(spec.split(":")[1]))
    if spec.endswith(".bvp") or spec.endswith(".zip"):
        return readers.load_volume(readers.BVPReader(spec),
                                   modality=args.modality)
    if spec.endswith(".raw"):
        if not args.raw_dims:
            raise SystemExit("--raw-dims WIDTH,HEIGHT,DEPTH required "
                             "for raw volumes")
        w, h, d = (int(x) for x in args.raw_dims.split(","))
        gl_type = {"uint8": 5121, "uint16": 5123,
                   "float32": 5126}[args.raw_type]
        reader = readers.RAWReader(spec, w, h, d, gl_type=gl_type)
        return readers.load_volume(reader)
    raise SystemExit(f"unrecognized volume spec: {spec}")


def _build_context(args):
    from .runtime import RenderingContext
    from .transfer import TransferFunctionBumps, gray_ramp, rasterize

    ctx = RenderingContext(resolution=args.resolution,
                           precision=args.precision,
                           tracking=getattr(args, "tracking", "auto"),
                           tf_srgb=getattr(args, "tf_srgb", False))
    ctx.set_volume(_load_volume(args))

    if args.tf:
        with open(args.tf) as f:
            ctx.set_transfer_function(
                rasterize(TransferFunctionBumps.from_json(f.read())))
    else:
        ctx.set_transfer_function(gray_ramp(alpha_scale=args.tf_alpha))

    if args.envmap:
        from . import environment as env_mod
        from .io.image import read_image
        ctx.set_environment_map(env_mod.from_image(read_image(args.envmap)))

    from .renderers import factory
    params = _collect_params(args, args.renderer,
                             factory.get_module(args.renderer).Params)
    ctx.choose_renderer(args.renderer, params=params)
    ctx.choose_tone_mapper(args.tonemap,
                           **({"exposure": args.exposure,
                               "gamma": args.gamma}
                              if args.tonemap not in ("artistic", "range")
                              else {}))

    # volume TRS (RenderingContextDialog parity)
    from . import math3d as m4
    if getattr(args, "volume_translate", None):
        ctx.volume_transform.local_translation = args.volume_translate
    if getattr(args, "volume_rotate", None):
        ctx.volume_transform.local_rotation = m4.quat_from_euler(
            *args.volume_rotate)
    if getattr(args, "volume_scale", None):
        ctx.volume_transform.local_scale = args.volume_scale

    # camera pose
    ctx.camera_animator.distance = args.camera_distance
    ctx.camera_animator.yaw = args.yaw
    ctx.camera_animator.pitch = args.pitch
    ctx.camera_animator._update_camera()
    return ctx


def _add_common_args(p):
    from .renderers import factory
    from .tonemap import TONE_MAPPERS

    p.add_argument("--volume", required=True,
                   help="sphere:N | shell:N | blobs:N | file.raw | file.bvp")
    p.add_argument("--modality", default="default",
                   help="modality name inside a BVP archive "
                        "(list with: vpt_jax info --volume FILE)")
    p.add_argument("--raw-dims", help="W,H,D for raw volumes")
    p.add_argument("--raw-type", default="uint8",
                   choices=["uint8", "uint16", "float32"])
    p.add_argument("--renderer", default="mcm",
                   choices=sorted(factory.MODULES))
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--spp", type=int, default=32,
                   help="progressive samples (frames) to accumulate")
    p.add_argument("--tf", help="transfer-function JSON (widget format)")
    p.add_argument("--tf-alpha", type=float, default=1.0,
                   help="alpha scale of the default gray-ramp TF")
    p.add_argument("--envmap", help="equirectangular environment image "
                                    "(8-bit PNG)")
    p.add_argument("--tonemap", default="reinhard",
                   choices=sorted(TONE_MAPPERS))
    p.add_argument("--exposure", type=float, default=1.0)
    p.add_argument("--gamma", type=float, default=2.2)
    p.add_argument("--camera-distance", type=float, default=2.0)
    p.add_argument("--yaw", type=float, default=0.0)
    p.add_argument("--pitch", type=float, default=0.0)
    p.add_argument("--volume-translate", metavar="X,Y,Z",
                   type=lambda s: tuple(float(x) for x in s.split(",")))
    p.add_argument("--volume-rotate", metavar="XDEG,YDEG,ZDEG",
                   type=lambda s: tuple(float(x) for x in s.split(",")),
                   help="euler rotation of the volume (degrees)")
    p.add_argument("--volume-scale", metavar="X,Y,Z",
                   type=lambda s: tuple(float(x) for x in s.split(",")))
    p.add_argument("--precision", default="fast",
                   choices=["fast", "exact"],
                   help="fast: bf16 sampling tables; exact: float32")
    p.add_argument("--tracking", default="auto",
                   choices=["none", "cheb", "grid", "auto"],
                   help="empty-space tracking for the MC renderers: "
                        "cheb-skip rides the corner gather (auto engages "
                        "it on scenes with TF-empty cells); grid = the "
                        "coarse local-majorant grid; none = the exact "
                        "GLSL-stream machine")
    p.add_argument("--tf-srgb", action="store_true",
                   help="run the TF through the reference's SRGB8_ALPHA8 "
                        "texture semantics (8-bit quantize + sRGB decode)")
    for key, module in sorted(factory.MODULES.items()):
        _add_params_args(p, key, module.Params)


def cmd_render(args):
    ctx = _build_context(args)
    if args.resume:
        ctx.load_checkpoint(args.resume)
    t0 = time.perf_counter()
    import contextlib

    if args.trace:
        import jax
        trace_cm = jax.profiler.trace(args.trace)
    else:
        trace_cm = contextlib.nullcontext()
    with trace_cm:
        ctx.render(frames=args.spp)
        ctx.get_display_image().block_until_ready()
    dt = time.perf_counter() - t0
    ctx.save_image(args.output)
    if args.checkpoint:
        ctx.save_checkpoint(args.checkpoint)
    print(f"rendered {args.spp} spp at {args.resolution}^2 in {dt:.2f}s "
          f"-> {args.output}")
    print(ctx.profiler.summary())


def cmd_animate(args):
    from .runtime.animators import CircleAnimator

    ctx = _build_context(args)
    animator = None
    if args.path == "circle":
        animator = CircleAnimator(ctx.camera, radius=args.orbit_radius)
    ctx.record_animation(args.output, frames=args.frames, spp=args.spp,
                         animator=animator, video=args.video, fps=args.fps,
                         progress=lambda p: print(f"\r{p * 100:.0f}%",
                                                  end="", flush=True))
    print(f"\nwrote {args.frames} frames to {args.output}")


def cmd_fit(args):
    import jax.numpy as jnp
    import numpy as np

    from .io.image import read_image, write_png
    from .renderers import eam
    from .scene import CameraState, default_camera
    from .train import fit
    from .transfer import gray_ramp

    if args.method != "eam" and getattr(args, "inpaint_blind", False):
        raise SystemExit("--inpaint-blind is eam-only (multi-view "
                         "targets); mcm/mcs fits use --inpaint")
    if args.method != "eam" and len(args.target) > 1:
        raise SystemExit(f"--method {args.method} takes a single --target; "
                         "multi-view fitting is eam-only")
    n = args.grid
    init = jnp.full((n, n, n, 1), 0.1, jnp.float32)
    tf = gray_ramp(alpha_scale=1.0)
    if args.method == "iso-depth":
        # inverse isosurface geometry from a depth map (BASELINE config 1)
        if args.inpaint:
            print("warning: --inpaint applies to the density-fitting "
                  "methods (eam/mcm/mcs) only — ignored for iso-depth")
        import optax

        from .renderers import diff_iso, make_scene

        if not args.target[0].endswith(".npy"):
            raise SystemExit(
                "--method iso-depth expects an .npy depth map (H, W) "
                "float32 with -1 marking invalid pixels — e.g. "
                "np.save of diff_iso.render(...)['depth']")
        target_depth = jnp.asarray(np.load(args.target[0]), jnp.float32)
        h, w = target_depth.shape
        params = diff_iso.Params()
        template = make_scene(init, tf, pack=False)
        import jax as jax_mod

        loss_grad = jax_mod.jit(jax_mod.value_and_grad(
            lambda v: diff_iso.depth_loss(v, template, params,
                                          target_depth, h, w)))
        opt = optax.adam(args.lr)
        vol, opt_state = init, opt.init(init)
        for i in range(args.steps):
            loss, g = loss_grad(vol)
            updates, opt_state = opt.update(g, opt_state, vol)
            vol = jnp.clip(optax.apply_updates(vol, updates), 0.0, 1.0)
            if i % 25 == 0:
                print(f"step {i}: depth MSE {float(loss):.6f}")
        np.save(args.output, np.asarray(vol))
        print(f"final depth MSE {float(loss):.6f}; wrote {args.output}.npy")
        return
    def maybe_inpaint(vol, extinction):
        """Occlusion-aware completion of the fit's null space
        (vpt_jax.inpaint): voxels optically thick from every axis
        direction are filled with the log-domain biharmonic continuation
        of the recovered material.  tau default from the committed
        config-3 sweep (docs/ARCHITECTURE.md "Occlusion completion":
        optimum basin [0.1, 0.2] —
        masks from a fitted volume need tau far below 1 because
        underfilled cores under-report their own occlusion)."""
        if not args.inpaint:
            return vol
        from . import inpaint as inpaint_mod

        filled, mask = inpaint_mod.complete_occluded(
            vol[..., 0], extinction=float(extinction),
            tau=args.inpaint_tau)
        print(f"inpainted {float(mask.mean()) * 100:.2f}% of voxels "
              f"(tau={args.inpaint_tau:g}, extinction={extinction:g})")
        return jnp.clip(filled, 0.0, 1.0)[..., None]

    target = jnp.asarray(read_image(args.target[0]))
    if args.method in ("mcm", "mcs"):
        # Monte-Carlo inverse rendering through the detached-decision
        # estimators (BASELINE config 3)
        from .renderers import make_scene
        from . import train as fit_mc_mod
        from .train import fit_mc

        template = make_scene(init, tf, pack=False)
        vol, _, losses = fit_mc(
            target, template, init_volume=init, renderer=args.method,
            frames=args.mc_frames, steps=args.steps,
            learning_rate=args.lr, verbose=True)
        vol = maybe_inpaint(vol, fit_mc_mod.MC_FIT_EXTINCTION[args.method])
        np.save(args.output, np.asarray(vol))
        print(f"final loss {losses[-1]:.6f}; wrote {args.output}.npy")
        return
    # multi-view EAM fitting: one camera per target image.  Single-view
    # reconstruction is ill-posed along the view axis (train.fit docstring);
    # pass several orbit views of the same object to resolve it.
    import math

    from .runtime.animators import OrbitCameraAnimator

    targets = [jnp.asarray(read_image(t)) for t in args.target]
    n_views = len(targets)
    yaws = args.view_yaw
    if yaws is None:
        # default: spread views evenly over a full horizontal orbit
        yaws = [360.0 * i / n_views for i in range(n_views)]
    pitches = args.view_pitch or [0.0] * n_views
    if len(yaws) != n_views or len(pitches) != n_views:
        raise SystemExit("--view-yaw/--view-pitch must match the number "
                         "of --target images")

    cam = default_camera()
    orbit = OrbitCameraAnimator(cam)
    orbit.distance = args.camera_distance
    views = []
    for yaw, pitch in zip(yaws, pitches):
        orbit.yaw = math.radians(yaw)
        orbit.pitch = math.radians(pitch)
        orbit._update_camera()
        cs = CameraState.from_nodes(cam)
        views.append((cs.mvp_inverse, cs.model_view, cs.projection))

    params = eam.Params(slices=args.eam_slices or 64, random=False)

    # truth-blind completion (--inpaint-blind): withhold the LAST target
    # from the fit and use it to select the completion threshold by
    # reprojection (inpaint.select_tau_blind); requires >= 3 views so the
    # fit keeps at least two
    blind = args.inpaint_blind
    if blind and n_views < 3:
        raise SystemExit("--inpaint-blind needs at least 3 --target views "
                         "(the last is withheld for tau selection)")
    fit_targets = targets[:-1] if blind else targets
    fit_views = views[:-1] if blind else views

    vol, _, losses = fit(fit_targets, fit_views, init, tf,
                         steps=args.steps, learning_rate=args.lr,
                         params=params, verbose=True)
    if blind:
        from . import inpaint as inpaint_mod
        from .train import render_eam as _render_eam

        h_t, w_t = targets[-1].shape[:2]
        cam_pos = jnp.stack([inpaint_mod.camera_position(mv)
                             for (_, mv, _) in fit_views])
        depth = inpaint_mod.optical_depth_views(
            vol[..., 0], float(params.extinction), cam_pos)

        def render_heldout(v):
            return [_render_eam(jnp.asarray(v)[..., None], tf, views[-1],
                                params, jnp.float32(0.0), h_t, w_t)]

        taus = tuple(float(t) for t in args.blind_taus.split(","))
        tau_blind, completed, table = inpaint_mod.select_tau_blind(
            vol[..., 0], taus, [targets[-1]], render_heldout,
            depth=depth)
        print("blind tau selection: " + "; ".join(
            f"tau={r['tau']}: fill={r['filled_frac']:.3f} "
            f"heldout={r['heldout_mse']:.2e}" for r in table))
        print(f"chosen tau = {tau_blind}")
        vol = jnp.clip(jnp.asarray(completed), 0.0, 1.0)[..., None]
    else:
        vol = maybe_inpaint(vol, params.extinction)
    np.save(args.output, np.asarray(vol))
    from .train import render_eam
    pred = render_eam(vol, tf, views[0], params, jnp.float32(0.0),
                      *targets[0].shape[:2])
    write_png(args.output + ".png", np.asarray(pred))
    print(f"final loss {losses[-1]:.6f} over {n_views} view(s); "
          f"volume -> {args.output}.npy")


def cmd_serve(args):
    from .io.server import serve

    serve(args.dir, args.port)


def cmd_view(args):
    from .runtime.viewer import ViewerServer

    ctx = _build_context(args)
    ViewerServer(ctx, port=args.port).serve_forever()


def cmd_info(args):
    from .renderers import factory
    from .tonemap import TONE_MAPPERS

    if getattr(args, "volume", None):
        import os

        from .io import readers

        if not args.volume.endswith((".bvp", ".zip")):
            raise SystemExit(
                f"info --volume expects a .bvp/.zip archive with a "
                f"manifest, got: {args.volume}")
        if not os.path.exists(args.volume):
            raise SystemExit(f"no such file: {args.volume}")
        mods = readers.list_modalities(readers.BVPReader(args.volume))
        print(f"modalities in {args.volume}:")
        for m in mods:
            dims = m["dimensions"]
            print(f"  {m['name']:16s} {dims['width']}x{dims['height']}"
                  f"x{dims['depth']}  format={m['format']} type={m['type']}")
        return

    print(f"renderers (cost = ms/frame at 512^2 defaults, "
          f"{factory.FRAME_COST_DEVICE}):")
    for key, module in sorted(factory.MODULES.items()):
        fields = ", ".join(
            f"{f.name}={f.default}" for f in
            dataclasses.fields(module.Params))
        cost = factory.FRAME_COST_MS_512.get(key)
        tag = f"~{cost:5.1f} ms" if cost else "    ?    "
        print(f"  {key:6s} [{tag}] {fields}")
    print("tone mappers:", ", ".join(sorted(TONE_MAPPERS)))


def main(argv=None):
    from .runtime.device import enable_compile_cache

    enable_compile_cache()
    parser = argparse.ArgumentParser(prog="vpt_jax", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("render", help="progressive render to PNG")
    _add_common_args(p)
    p.add_argument("--output", "-o", default="render.png")
    p.add_argument("--checkpoint", help="save progressive state here")
    p.add_argument("--resume", help="resume progressive state from here")
    p.add_argument("--trace", help="write a jax.profiler trace (TensorBoard "
                                   "format) of the render to this directory")
    p.set_defaults(func=cmd_render)

    p = sub.add_parser("animate", help="render an animation sequence")
    _add_common_args(p)
    p.add_argument("--output", "-o", default="frames")
    p.add_argument("--frames", type=int, default=36)
    p.add_argument("--path", default="orbit", choices=["orbit", "circle"])
    p.add_argument("--orbit-radius", type=float, default=0.5)
    p.add_argument("--video", help="also encode the animation to video "
                                   "(.mp4/.webm/.avi via OpenCV, .gif via "
                                   "PIL; degrades to GIF with a message "
                                   "when no encoder exists)")
    p.add_argument("--fps", type=int, default=25)
    p.set_defaults(func=cmd_animate)

    p = sub.add_parser("fit", help="inverse-render a volume from images")
    p.add_argument("--target", required=True, nargs="+",
                   help="target image(s) (PNG); several targets fit "
                        "multi-view (eam method only)")
    p.add_argument("--view-yaw", type=float, nargs="+", default=None,
                   help="per-target camera yaw in degrees (default: even "
                        "spread over a full orbit)")
    p.add_argument("--view-pitch", type=float, nargs="+", default=None,
                   help="per-target camera pitch in degrees (default 0)")
    p.add_argument("--camera-distance", type=float, default=2.0)
    p.add_argument("--grid", type=int, default=32)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--eam-slices", type=int, default=None)
    p.add_argument("--method", default="eam",
                   choices=["eam", "mcm", "mcs", "iso-depth"],
                   help="differentiable path: eam (deterministic image), "
                        "mcm/mcs (Monte-Carlo expected-value estimators), "
                        "iso-depth (soft isosurface depth fitting; .npy "
                        "target)")
    p.add_argument("--mc-frames", type=int, default=32,
                   help="MC frames averaged per optimization step")
    p.add_argument("--inpaint", action="store_true",
                   help="complete the fit's occluded null space after "
                        "optimization (vpt_jax.inpaint: optical-depth "
                        "visibility + log-domain biharmonic CG fill; "
                        "eam/mcm/mcs methods)")
    p.add_argument("--inpaint-blind", action="store_true",
                   help="truth-free completion for the multi-view eam "
                        "fit: the LAST --target view is withheld from "
                        "the fit; per-voxel visibility integrates along "
                        "the fit views' capture rays and the threshold "
                        "is chosen by held-out reprojection "
                        "(inpaint.select_tau_blind)")
    p.add_argument("--blind-taus", default="0.05,0.1,0.15,0.25,0.5,1.0",
                   help="candidate thresholds for --inpaint-blind")
    p.add_argument("--inpaint-tau", type=float, default=0.15,
                   help="visibility threshold.  The default is the "
                        "committed config-3 sweep optimum AT extinction "
                        "25 (docs/ARCHITECTURE.md); the mask thresholds "
                        "extinction-scaled optical depth, so re-sweep "
                        "(or scale) tau when fitting at a different "
                        "extinction or scene family")
    p.add_argument("--output", "-o", default="fitted_volume")
    p.set_defaults(func=cmd_fit)

    p = sub.add_parser("view", help="interactive browser viewer")
    _add_common_args(p)
    p.add_argument("--port", type=int, default=8000)
    p.set_defaults(func=cmd_view)

    p = sub.add_parser("serve", help="range-request static server")
    p.add_argument("--dir", default=".")
    p.add_argument("--port", type=int, default=3000)
    p.set_defaults(func=cmd_serve)

    p = sub.add_parser("info", help="list renderers and parameters, or "
                                    "the modalities of a BVP archive")
    p.add_argument("--volume", help="BVP archive to inspect")
    p.set_defaults(func=cmd_info)

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
