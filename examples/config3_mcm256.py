"""BASELINE config 3, end to end: MCM multiple scattering on a 256³ volume,
voxel-density gradients, ≥1024 spp accumulated targets, recover a perturbed
volume — coarse-to-fine multiresolution over 10 orbit views (3 views / 16M
voxels is too ill-posed, so the fit ascends 32³ → 64³ → 128³ → 256³ with
trilinear upsampling between stages, each stage descending the same
full-resolution multi-view targets with per-step stochastic view
selection).

Pipeline:
1. Ground truth: 256³ Gaussian-blobs volume (volume.blobs_volume).
2. Targets: MCM progressive renders from 10 orbit views (alternating
   pitch, full yaw circle), accumulated until mean samples/pixel ≥ 1024
   (the analog forward machine, bf16 fast path).
3. Perturbation: truth box-blurred (13³) and dimmed 0.55× — geometry
   smeared and extinction wrong.  (The blur error lives at a coarse
   spatial scale, which is exactly what the 32³ stage can see and fix.)
4. Recovery: per-stage Adam on the raw voxel grid through the detached-
   decision MC estimator (diff_mc.mcm_expected_image) with in-graph
   corner packing, A/B-split loss, one randomly-cycled view per step
   (stochastic multi-view SGD — one compiled step graph for every
   (view, extinction) pair, cameras and extinction passed as traced
   values), optional TV prior, coarse to fine with a dual-extinction
   final stage.
5. Artifacts: loss curve + voxel-MSE numbers on stdout (and JSON), a
   target/init/fitted gallery PNG per view.

Variance control and optimizer choice (all measured — r2 at 64³, r3 on
the full multiresolution pipeline):
- **A/B-split loss** ``mean((A−t)(B−t))`` over two independent estimates:
  a plain MSE on a few-frame MC estimate is dominated by the estimate's
  own variance (measured loss(truth) ≈ loss(init)), so its gradient
  optimizes the estimator's variance, not the match.  The split removes
  the variance term (unbiased estimate of the squared bias).
- **Adam with cosine decay, per stage** (r3 revision of the r2 SGD
  choice): at 256³ single-resolution Adam random-walks rarely-visited
  voxels (the r2 measurement), but in the coarse-to-fine schedule every
  coarse-stage voxel is densely constrained, where Adam descends 2×
  faster than SGD+momentum (docs/ARCHITECTURE.md "Config-3 null space").
- **Dual-extinction capture**: at the primary extinction the blob cores
  are optically occluded (a measured gradient null space — core-bucket
  MSE never moves); a second, lower-extinction target set carries core
  signal (~30× pixel noise, localized) and joins at the native
  resolution, where the transport-model gap that biases it at coarse
  grids is gone.
- diff_mc also exposes ``score_floor`` (drops the 1/p score tail of
  low-probability decisions) as a biased-but-bounded fallback; not
  needed for this config.

Run: python examples/config3_mcm256.py
Quick CPU check: JAX_PLATFORMS=cpu python examples/config3_mcm256.py --quick
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def box_blur(vol, k: int):
    """Separable k³ mean filter with edge padding (the perturbation)."""
    import jax.numpy as jnp

    v = vol[..., 0]
    for axis in range(3):
        pad = [(0, 0)] * 3
        pad[axis] = (k // 2, k // 2)
        vp = jnp.pad(v, pad, mode="edge")
        kernel_shape = [1, 1, 1]
        kernel_shape[axis] = k
        from jax import lax
        v = lax.reduce_window(vp, 0.0, lax.add, tuple(kernel_shape),
                              (1, 1, 1), "VALID") / k
    return v[..., None]


def _base_params():
    from vpt_jax.renderers import mcm as mcm_mod

    return mcm_mod.Params(extinction=25.0, anisotropy=0.2, steps=8)


def orbit_cameras(yaws_deg, pitches=None):
    import math

    from vpt_jax.runtime.animators import OrbitCameraAnimator
    from vpt_jax.scene import CameraState, default_camera

    out = []
    for i, yaw in enumerate(yaws_deg):
        cam = default_camera()
        orbit = OrbitCameraAnimator(cam)
        orbit.yaw = math.radians(yaw)
        if pitches is not None:
            orbit.pitch = pitches[i % len(pitches)]
        orbit._update_camera()
        out.append(CameraState.from_nodes(cam))
    return out


def resize_volume(vol, n):
    """Trilinear resample of a (D, H, W, 1) grid to (n, n, n, 1)."""
    import jax

    return jax.image.resize(vol, (n, n, n, vol.shape[-1]), "trilinear")


_RENDER_JIT = {}


def _frame_fn():
    """One jit wrapper shared by every render_target call — a fresh
    jax.jit(...) per call would recompile for every target even though
    the shapes never change."""
    import jax

    from vpt_jax.renderers import mcm

    if "fn" not in _RENDER_JIT:
        _RENDER_JIT["fn"] = jax.jit(mcm.render_frame, donate_argnums=(0,))
    return _RENDER_JIT["fn"]


def render_target(vol, tf, cam, params, res, min_spp, label):
    """Progressive analog MCM until mean samples/pixel >= min_spp."""
    import jax.numpy as jnp

    from vpt_jax.renderers import make_scene, mcm

    scene = make_scene(vol, tf, camera=cam, pack_dtype=jnp.bfloat16,
                       tf_mxu=True)
    state = mcm.reset(params, res, res, scene)
    frame_fn = _frame_fn()
    i, spp = 0, 0.0
    t0 = time.perf_counter()
    while spp < min_spp:
        for _ in range(64):
            i += 1
            state = frame_fn(state, scene, params,
                             jnp.float32(0.1 + 0.003 * i), jnp.int32(i))
        spp = float(np.asarray(jnp.mean(state["samples"])))
    dt = time.perf_counter() - t0
    print(f"  {label}: {spp:.0f} spp in {i} frames, {dt:.1f}s "
          f"({res * res * params.steps * i / dt / 1e6:.1f}M events/s)")
    return np.asarray(state["radiance"])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="64^3 volume / 64^2 images / small budgets (CPU)")
    ap.add_argument("--out", default="examples/config3_gallery.png")
    ap.add_argument("--lr", type=float, default=None,
                    help="SGD lr base; per stage it scales as lr·(n/64) — "
                         "per-voxel gradient magnitude scales with events "
                         "per voxel")
    ap.add_argument("--steps", type=int, default=None,
                    help="override the final stage's step count")
    ap.add_argument("--final-lr", type=float, default=None,
                    help="override the final stage's Adam lr0")
    ap.add_argument("--tv", type=float, default=0.0,
                    help="total-variation prior weight (optional; alias "
                         "for --prior tv --prior-w W)")
    ap.add_argument("--prior", default="none",
                    choices=("none", "tv", "curv", "logcurv", "lap",
                             "loglap"),
                    help="conditioning prior for the occluded-core null "
                         "space: 'tv' = squared forward "
                         "differences (H1 smoothness), 'curv' = squared "
                         "gradient-of-Laplacian (zero on quadratic caps — "
                         "extrapolates the recovered shell into cores "
                         "without pressuring flat empty space), "
                         "'logcurv' = the same penalty on "
                         "log(max(v, 0.01)) — a Gaussian blob is exactly "
                         "quadratic in log space, so its occluded core is "
                         "penalty-free only when filled to the Gaussian "
                         "continuation of the visible shell; 'lap' / "
                         "'loglap' = biharmonic mean(lap^2) (4th order: "
                         "soft enough for Adam to actually descend — the "
                         "prior-flow probe measured the 6th-order curv "
                         "flow checkerboarding while lap fills cores "
                         "0.153 -> 0.033)")
    ap.add_argument("--prior-w", type=float, default=0.0,
                    help="prior weight (on the stage mean penalty, at the "
                         "native grid; coarser stages are rescaled by "
                         "--prior-scale-pow)")
    ap.add_argument("--prior-from", type=int, default=256,
                    help="apply the prior at stages with grid >= this "
                         "(default: native resolution only; set 32 for "
                         "the multiscale variant — coarse stages fill "
                         "cores a few voxels deep, upsampling carries "
                         "the fill to the native grid)")
    ap.add_argument("--prior-scale-pow", type=float, default=6.0,
                    help="per-stage weight = w * (n/256)^pow: 6 equalizes "
                         "the curv prior's world-space strength across "
                         "grids (the discrete grad-of-Laplacian scales as "
                         "h^3); smaller boosts the coarse stages")
    ap.add_argument("--param", default="raw", choices=("raw", "pyramid"),
                    help="final-stage parametrization: 'pyramid' "
                         "optimizes a Gaussian-pyramid decomposition "
                         "{32, 64, 128, 256} jointly (a regularized "
                         "parametrization) — "
                         "coarse coefficients aggregate image gradients "
                         "over whole blob neighborhoods, so occluded "
                         "cores inherit coarse structure instead of "
                         "sitting in a per-voxel null space")
    ap.add_argument("--save-fit", default="",
                    help="save the fitted 256^3 volume (npz) for "
                         "forensics")
    ap.add_argument("--inpaint", action="store_true",
                    help="after the fit, complete the optically occluded "
                         "null space with vpt_jax.inpaint (6-axis "
                         "visibility mask at the primary extinction + "
                         "log-domain biharmonic CG solve) — solving the "
                         "prior's Euler-Lagrange equation on the unseen "
                         "set instead of descending it in-loop "
                         "(docs/ARCHITECTURE.md: why descent cannot fill "
                         "cores)")
    ap.add_argument("--inpaint-tau", type=float, default=0.15,
                    help="visibility threshold: optical depth above which "
                         "a voxel counts as unobserved.  Default from the "
                         "committed benchmarks/inpaint_sweep.py sweep on "
                         "the r4 fit: the optimum sits in a broad "
                         "[0.1, 0.2] basin (total voxel MSE 4.5e-4 at "
                         "0.15) because the mask must be computed from "
                         "the FITTED volume, whose underfilled cores "
                         "under-report their own occlusion — tau well "
                         "below the 'optically thick' 1.0 compensates; "
                         "0.05 over-masks and corrupts the visible shell.  "
                         "The proxy depth is extinction-linear, so this "
                         "mask at the primary extinction equals a "
                         "min(exts) mask at tau*min/primary — voxels the "
                         "low-extinction captures constrain ARE inside "
                         "the swept optimum (advisor r4); the "
                         "--inpaint-blind protocol supersedes this with "
                         "view-aware visibility at min(exts)")
    ap.add_argument("--inpaint-blind", action="store_true",
                    help="truth-free completion protocol: "
                         "fit WITHOUT the --heldout views, compute the "
                         "view-aware visibility field along the actual "
                         "fit-view capture rays (--blind-ext; default "
                         "the primary extinction), and choose tau by "
                         "held-out-view reprojection "
                         "(inpaint.select_tau_blind) — ground truth is "
                         "touched only to REPORT the resulting voxel MSE")
    ap.add_argument("--heldout", default="3,7",
                    help="view indices withheld from the fit and used "
                         "for blind tau selection (--inpaint-blind)")
    ap.add_argument("--blind-taus", default="0.05,0.1,0.15,0.25,0.5,1.0",
                    help="candidate thresholds for the blind sweep.  The "
                         "r5 first run measured that a FITTED volume "
                         "under-reports its own occlusion on the "
                         "view-aware field exactly as it did on the "
                         "proxy: at min(exts) the field "
                         "barely crosses 0.25 anywhere, so candidates "
                         "must span the under-reporting regime — the "
                         "held-out veto, not the physical tau=1 "
                         "intuition, is what keeps low taus safe")
    ap.add_argument("--blind-ext", type=float, default=None,
                    help="extinction for the view-aware visibility "
                         "field (default: the PRIMARY capture "
                         "extinction — the r5 first run measured the "
                         "min(exts) field too shallow on fitted "
                         "volumes; the field is extinction-linear, so "
                         "this only rescales the tau axis the blind "
                         "sweep searches)")
    ap.add_argument("--cache", default="examples/config3_cache.npz",
                    help="cache file for the rendered targets AND the "
                         "pre-final-stage fit (they are identical across "
                         "prior settings when --prior-from is the native "
                         "grid, so prior sweeps only pay the final stage); "
                         "'' disables")
    ap.add_argument("--fused-vjp", action="store_true", default=True)
    ap.add_argument("--no-fused-vjp", dest="fused_vjp",
                    action="store_false",
                    help="disable the fused select+lerp cotangent "
                         "(sampling._select_trilerp; values identical)")
    ap.add_argument("--exts", default="25,5",
                    help="comma-separated target extinctions; the first "
                         "is primary (gallery/params), later ones are the "
                         "low-extinction capture that penetrates occluded "
                         "cores (fine stages only)")
    args = ap.parse_args()

    import jax

    import dataclasses

    import jax.numpy as jnp
    import optax

    from vpt_jax import sampling, tonemap, transfer, volume
    from vpt_jax.io.image import write_png
    from vpt_jax.renderers import diff_mc, make_scene
    from vpt_jax.renderers import mcm as mcm_mod

    if args.tv > 0.0 and args.prior == "none":
        args.prior, args.prior_w = "tv", args.tv

    n = 64 if args.quick else 256
    res = 64 if args.quick else 256
    min_spp = 64 if args.quick else 2048
    n_views = 4 if args.quick else 10
    exts = tuple(float(x) for x in args.exts.split(","))
    # coarse-to-fine schedule: (grid, steps, grad frames, adam lr0, dual)
    # - coarse/mid stages fit the PRIMARY extinction only: a coarse
    #   transport model biases the low-extinction images' optimum (the
    #   image-optimal coarse volume undershoots blob cores — measured at
    #   32^3 AND 64^3), so the aux extinction joins only at the native
    #   resolution where the model gap is gone
    # - the aux (lower) extinction penetrates the cores the primary one
    #   occludes (measured: at ext 25 the cores are a gradient null space;
    #   at ext 5 their image signal is ~30x the pixel noise but localized
    #   — docs/ARCHITECTURE.md "Config-3 null space")
    if args.quick:
        stages = [(16, 6, 2, 3e-3, False), (n, args.steps or 6, 2,
                   1e-3, True)]
    else:
        stages = [(32, 300, 16, 3e-3, False),
                  (64, 200, 8, 1.5e-3, False),
                  (128, 150, 6, 8e-4, False),
                  (256, args.steps or 160, 4, 5e-4, True)]

    truth = volume.blobs_volume(n, seed=3, count=6).data
    tf = transfer.gray_ramp(alpha_scale=0.9)
    pitches = (0.25, -0.35)
    cams = orbit_cameras(np.arange(n_views) * (360.0 / n_views), pitches)

    held_ids = tuple(int(x) for x in args.heldout.split(",")) \
        if args.inpaint_blind else ()
    if any(i >= n_views for i in held_ids):
        raise SystemExit(f"--heldout {held_ids} out of range ({n_views})")
    fit_ids = [i for i in range(n_views) if i not in held_ids]

    print(f"config 3: {n}^3 volume, {res}^2 images, {n_views} views, "
          f"extinctions {exts}, >= {min_spp} spp targets, stages {stages}, "
          f"prior {args.prior}/{args.prior_w:g} from {args.prior_from}^3")
    t_all = time.perf_counter()

    # -- target / pre-final-stage cache (prior sweeps re-run only the
    # stage(s) the prior actually changes) --------------------------------
    cache_key = (f"n{n}res{res}spp{min_spp}v{n_views}exts{args.exts}"
                 f"stages{stages[:-1]}lr{args.lr}")
    cache = {}
    if args.cache and pathlib.Path(args.cache).exists():
        with np.load(args.cache, allow_pickle=False) as z:
            if str(z["key"]) == cache_key:
                cache = {k: z[k] for k in z.files if k != "key"}
                print(f"  cache hit: {args.cache} ({len(cache)} arrays)")
            else:
                print(f"  cache key mismatch — re-rendering ({args.cache})")

    tsets = {}
    for ext in exts:
        p_ext = dataclasses.replace(_base_params(), extinction=ext)
        tsets[ext] = [
            cache[f"t_e{ext:g}_v{i}"] if f"t_e{ext:g}_v{i}" in cache
            else render_target(truth, tf, cam, p_ext, res, min_spp,
                               f"target e{ext:g} v{i}")
            for i, cam in enumerate(cams)]
    params = dataclasses.replace(_base_params(), extinction=exts[0])
    targets = tsets[exts[0]]

    init = jnp.clip(0.55 * box_blur(truth, 13), 0.0, 1.0)
    voxel_mse0 = float(jnp.mean((init - truth) ** 2))
    templates = [make_scene(truth, tf, camera=cam, pack=False)
                 for cam in cams]
    tstack = {ext: jnp.stack([jnp.asarray(t) for t in tsets[ext]])
              for ext in exts}

    def loss_fn(voxels, scene_tmpl, tgts, seed0, grad_frames, use_exts,
                prior_w):
        # one view per step (stochastic multi-view SGD): camera matrices
        # are traced scene leaves, so all views share one compiled graph;
        # extinction is traced too, so every (view, extinction) pair does.
        # The fold keeps the backward scatter below the row-count cliff
        # (+37% grad throughput at 256^3, sampling.py's fold note); the
        # fused select+lerp cotangent (sampling._select_trilerp) cuts the
        # backward's transpose cost on top (values bit-identical).
        fold = sampling.scatter_fold_log2(
            voxels.shape[0] * voxels.shape[1] * voxels.shape[2],
            8 * voxels.shape[3], voxels.shape[2])
        packed = sampling.pack_corner_volume(voxels, fold)
        sc = dataclasses.replace(
            scene_tmpl, volume=voxels, volume_packed=packed,
            transfer_packed=sampling.pack_corner_texture2d(
                scene_tmpl.transfer),
            fused_vjp=args.fused_vjp)
        loss = 0.0
        for ext, tgt in zip(use_exts, tgts):
            p_ext = dataclasses.replace(params, extinction=ext)
            a = diff_mc.mcm_expected_image(sc, p_ext, res, res,
                                           grad_frames, seed0=seed0 + ext)
            b = diff_mc.mcm_expected_image(sc, p_ext, res, res,
                                           grad_frames,
                                           seed0=seed0 + ext + 131.9)
            loss = loss + jnp.mean((a - tgt) * (b - tgt))
        if prior_w > 0.0:
            v = voxels[..., 0]
            if args.prior == "tv":
                # H1 smoothness: squared forward differences
                pen = sum(jnp.mean((jnp.roll(v, -1, a_) - v) ** 2)
                          for a_ in range(3))
            else:
                # 'curv': squared gradient-of-Laplacian — zero on any
                # quadratic field, so it extrapolates the data-constrained
                # shell into the occluded cores (a paraboloid cap) while
                # exactly ignoring flat empty space (all derivatives 0).
                # 'logcurv': same penalty in log space, where a Gaussian
                # blob is exactly quadratic (clamped at 0.01 so exact
                # empty space stays penalty-free).
                # 'lap'/'loglap': biharmonic mean(lap^2) — one order
                # softer, which is what lets Adam's per-voxel normalized
                # steps actually descend it (docs/ARCHITECTURE.md).
                if args.prior in ("logcurv", "loglap"):
                    v = jnp.log(jnp.maximum(v, 0.01))
                lap = sum(jnp.roll(v, -1, a_) + jnp.roll(v, 1, a_)
                          - 2.0 * v for a_ in range(3))
                if args.prior in ("lap", "loglap"):
                    pen = jnp.mean(lap ** 2)
                else:
                    pen = sum(jnp.mean((jnp.roll(lap, -1, a_) - lap) ** 2)
                              for a_ in range(3))
            loss = loss + prior_w * pen
        return loss

    def bucket_table(fit_vol, label):
        """Voxel MSE by truth-density bucket (the r3 null-space probe,
        docs/ARCHITECTURE.md "Config-3 null space")."""
        edges = (0.0, 0.05, 0.3, 0.7, 1.0000001)
        t = np.asarray(truth[..., 0])
        fv = np.asarray(fit_vol[..., 0])
        rows = []
        for lo, hi in zip(edges[:-1], edges[1:]):
            m = (t >= lo) & (t < hi)
            rows.append({"bucket": f"[{lo:g},{min(hi, 1.0):g})",
                         "frac": round(float(m.mean()), 4),
                         "mse": (float(np.mean((fv - t)[m] ** 2))
                                 if m.any() else 0.0)})
        print(f"  {label} voxel MSE by truth bucket: "
              + "  ".join(f"{r['bucket']}={r['mse']:.2e}" for r in rows))
        return rows

    # the blind prefit depends on WHICH views were withheld — a cached
    # fit from a different split would have trained on the "held-out"
    # views and silently un-blind the protocol
    prefit_key = (f"prefit_blind_h{args.heldout}" if args.inpaint_blind
                  else "prefit")

    def save_cache(prefit=None):
        if not args.cache:
            return
        data = {"key": cache_key}
        for ext in exts:
            for i in range(n_views):
                data[f"t_e{ext:g}_v{i}"] = np.asarray(tsets[ext][i])
        if prefit is not None:
            data[prefit_key] = np.asarray(prefit)
        elif prefit_key in cache:
            data[prefit_key] = cache[prefit_key]
        np.savez(args.cache, **data)
        print(f"  cache saved: {args.cache}")

    save_cache()

    # the pre-final fit differs between the full-view and blind (held-out)
    # protocols — separate cache entries
    losses = []
    vol_fit = None
    final_n = stages[-1][0]
    # the coarse stages are identical across (prior, final-lr, steps)
    # settings when the prior only acts at the native grid — cache the
    # pre-final-stage fit so prior sweeps pay the final stage only
    coarse_cacheable = args.prior_from >= final_n or args.prior_w == 0.0
    skip_coarse = coarse_cacheable and prefit_key in cache
    if skip_coarse:
        vol_fit = jnp.asarray(cache[prefit_key])
        print(f"  prefit cache hit: skipping stages {stages[:-1]}")
    t_fit = time.perf_counter()
    for n_fit, opt_steps, grad_frames, lr0, dual in stages:
        if skip_coarse and n_fit != final_n:
            continue
        if n_fit == final_n and args.final_lr:
            lr0 = args.final_lr
        vol_fit = resize_volume(init if vol_fit is None else vol_fit,
                                n_fit)
        vol_fit = jnp.clip(vol_fit, 0.0, 1.0)
        use_exts = exts if (dual and len(exts) > 1) else exts[:1]
        prior_w = (args.prior_w * (n_fit / final_n) ** args.prior_scale_pow
                   if (args.prior != "none" and n_fit >= args.prior_from)
                   else 0.0)
        pyramid = args.param == "pyramid" and n_fit == final_n
        if pyramid:
            # telescoping decomposition of the pre-final fit: the level-l
            # coefficients are the residual of level l/2's upsampling, so
            # the composed start point ≈ vol_fit and the coarse levels own
            # the blob-scale structure the image gradients can see
            levels = []
            lv = 32 if final_n >= 32 else final_n
            while lv <= final_n:
                levels.append(lv)
                lv *= 2
            downs = {lv: resize_volume(vol_fit, lv) for lv in levels}

            def pyr_compose(cs):
                return jnp.clip(
                    sum(resize_volume(c, final_n) for c in cs.values()),
                    0.0, 1.0)

            theta = {}
            for i, lv in enumerate(levels):
                theta[f"l{lv:04d}"] = (
                    downs[lv] if i == 0
                    else downs[lv] - resize_volume(downs[levels[i - 1]],
                                                   lv))
            vol_fit = pyr_compose(theta)
            print(f"  [pyramid] levels {levels}, composed-init voxel MSE "
                  f"{float(jnp.mean((resize_volume(vol_fit, n) - truth) ** 2)):.6f}")
        sched = optax.cosine_decay_schedule(lr0, opt_steps, alpha=0.05)
        optimizer = optax.adam(sched)
        if pyramid:
            opt_state = optimizer.init(theta)
            step_fn = jax.jit(jax.value_and_grad(
                lambda th_, tm_, tg_, s_, gf=grad_frames, ue=use_exts,
                pw=prior_w: loss_fn(pyr_compose(th_), tm_, tg_, s_, gf,
                                    ue, pw)))
        else:
            opt_state = optimizer.init(vol_fit)
            step_fn = jax.jit(jax.value_and_grad(
                lambda v_, tm_, tg_, s_, gf=grad_frames, ue=use_exts,
                pw=prior_w: loss_fn(v_, tm_, tg_, s_, gf, ue, pw)))
        order = np.random.default_rng(n_fit).permutation
        # blind protocol: the held-out views never enter the fit
        view_seq = np.concatenate(
            [np.asarray(fit_ids)[order(len(fit_ids))]
             for _ in range(opt_steps // len(fit_ids) + 1)])
        t_stage = time.perf_counter()
        for s in range(opt_steps):
            vi = int(view_seq[s])
            tgts = tuple(tstack[ext][vi] for ext in use_exts)
            arg0 = theta if pyramid else vol_fit
            loss, g = step_fn(arg0, templates[vi], tgts,
                              0.31 * s + 1000.0 * n_fit)
            updates, opt_state = optimizer.update(g, opt_state, arg0)
            if pyramid:
                theta = optax.apply_updates(theta, updates)
                vol_fit = pyr_compose(theta)
            else:
                vol_fit = jnp.clip(optax.apply_updates(vol_fit, updates),
                                   0.0, 1.0)
            losses.append(float(loss))
            if s == 0 and not pyramid:
                # calibration: where does the total gradient actually act?
                tr = np.asarray(resize_volume(truth, n_fit)[..., 0])
                gg = np.asarray(g[..., 0])
                print("    grad RMS " + "  ".join(
                    f"{tag}={float(np.sqrt(np.mean(gg[(tr >= lo) & (tr < hi)] ** 2))):.2e}"
                    for lo, hi, tag in ((0.7, 1.01, "core"),
                                        (0.05, 0.7, "shell"),
                                        (0.0, 0.05, "empty"))), flush=True)
            if s % 20 == 0 or s == opt_steps - 1:
                up = resize_volume(vol_fit, n)
                print(f"  [{n_fit}^3{'x' + str(len(use_exts)) + 'ext' if len(use_exts) > 1 else ''}] "
                      f"step {s:4d}: A/B loss {losses[-1]:+.6f}  voxel MSE "
                      f"{float(jnp.mean((up - truth) ** 2)):.6f}",
                      flush=True)
        print(f"  [{n_fit}^3] stage done in "
              f"{time.perf_counter() - t_stage:.1f}s")
        if n_fit != final_n and coarse_cacheable and not skip_coarse \
                and n_fit == stages[-2][0]:
            save_cache(prefit=vol_fit)
    fit_dt = time.perf_counter() - t_fit
    vol_fit = resize_volume(vol_fit, n)
    voxel_mse1 = float(jnp.mean((vol_fit - truth) ** 2))
    bucket_table(init, "init  ")
    buckets = bucket_table(vol_fit, "fitted")
    if args.save_fit:
        np.savez(args.save_fit, fit=np.asarray(vol_fit))

    inpaint_fields = {}
    if args.inpaint_blind:
        from vpt_jax import inpaint as inpaint_mod
        t_inp = time.perf_counter()
        # view-aware visibility: optical depth along the ACTUAL fit-view
        # capture rays, at the PRIMARY capture extinction by default —
        # the min(exts) field measured too shallow on fitted volumes
        # (docs/ARCHITECTURE.md "Occlusion completion"); the field is
        # extinction-linear, so the choice only rescales the tau axis
        # the blind sweep searches
        cam_pos = jnp.stack([inpaint_mod.camera_position(
            cams[i].model_view) for i in fit_ids])
        blind_ext = args.blind_ext if args.blind_ext else exts[0]
        depth = inpaint_mod.optical_depth_views(
            vol_fit[..., 0], blind_ext, cam_pos, n_steps=64,
            grid=min(n, 128))

        spp_eval = max(min_spp // 8, 64)

        def render_heldout(v):
            v4 = jnp.asarray(v)[..., None]
            outs = []
            for ext in exts:
                p_ext = dataclasses.replace(_base_params(),
                                            extinction=ext)
                for i in held_ids:
                    outs.append(render_target(
                        v4, tf, cams[i], p_ext, res, spp_eval,
                        f"blind-eval e{ext:g} v{i}"))
            return outs

        held_targets = [tsets[ext][i] for ext in exts for i in held_ids]
        taus = tuple(float(t) for t in args.blind_taus.split(","))
        tau_blind, completed, table = inpaint_mod.select_tau_blind(
            vol_fit[..., 0], taus, held_targets, render_heldout,
            depth=depth)
        vol_fit = jnp.clip(jnp.asarray(completed), 0.0, 1.0)[..., None]
        inpaint_fields = {
            "voxel_mse_inpaint_blind": float(
                jnp.mean((vol_fit - truth) ** 2)),
            "inpaint_blind_ext": blind_ext,
            "inpaint_tau_blind": tau_blind,
            "inpaint_blind_table": table,
            "inpaint_seconds": round(time.perf_counter() - t_inp, 1),
            "heldout_views": list(held_ids),
        }
        print(f"  blind tau selection: {json.dumps(table)}")
        print(f"  chosen tau = {tau_blind} (truth untouched)")
        buckets_done = bucket_table(vol_fit, "blind-inpaint")
        inpaint_fields["inpaint_buckets"] = buckets_done
    elif args.inpaint:
        from vpt_jax import inpaint as inpaint_mod
        t_inp = time.perf_counter()
        filled, unseen = inpaint_mod.complete_occluded(
            vol_fit[..., 0], extinction=exts[0], tau=args.inpaint_tau)
        vol_fit = jnp.clip(filled, 0.0, 1.0)[..., None]
        inpaint_fields = {
            "voxel_mse_inpaint": float(jnp.mean((vol_fit - truth) ** 2)),
            "inpaint_filled_frac": round(float(unseen.mean()), 5),
            "inpaint_tau": args.inpaint_tau,
            "inpaint_seconds": round(time.perf_counter() - t_inp, 1),
        }
        buckets_done = bucket_table(vol_fit, "inpaint")
        inpaint_fields["inpaint_buckets"] = buckets_done

    # gallery: rows = views, cols = target / init render / fitted render
    tm = tonemap.get("aces")
    rows = []
    for vi, cam in list(enumerate(cams))[:3]:
        row = [targets[vi]]
        for v in (init, vol_fit):
            row.append(render_target(v, tf, cam, params, res,
                                     min_spp // 4, f"gallery v{vi}"))
        rows.append(np.concatenate(
            [np.clip(np.asarray(tm(jnp.asarray(r))), 0, 1)[..., :3]
             for r in row], axis=1))
    gallery = np.concatenate(rows, axis=0)
    write_png(args.out, np.concatenate(
        [gallery, np.ones(gallery.shape[:2] + (1,), np.float32)], axis=-1))

    prior_tag = (f"+{args.prior}{args.prior_w:g}"
                 if args.prior != "none" and args.prior_w else "")
    if args.param != "raw":
        prior_tag += f"+{args.param}"
    summary = {
        "config": f"mcm/{n}^3/{res}^2/{n_views}views/{min_spp}spp/"
                  f"c2f/ext{args.exts}{prior_tag}",
        "image_mse_first": losses[0], "image_mse_last": losses[-1],
        "voxel_mse_init": voxel_mse0, "voxel_mse_fitted": voxel_mse1,
        "buckets": buckets,
        "fit_seconds": round(fit_dt, 1),
        "seconds_per_step": round(fit_dt / opt_steps, 2),
        "total_seconds": round(time.perf_counter() - t_all, 1),
        "gallery": args.out,
        **inpaint_fields,
    }
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
