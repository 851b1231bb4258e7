"""Decompose the loop-detector ingest batch cost on the device.

The detect stage is a large share of the endurance pipeline's wall
(tools/endurance_run.py). This harness times the
three device programs of one ingest batch separately — detect+describe,
fused match+verify, donated batch-append — at the endurance operating
point (pool 512, K=384, match_chunk=64, batch 8), with honest readback
fences, so optimization effort lands on the dominant phase instead of
guesses.

Run: python tools/profile_detect.py [--cpu] [--pool 512] [--fill 288]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--pool", type=int, default=512)
    ap.add_argument("--fill", type=int, default=288)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    from coxgraph_tpu.utils import runtime
    if args.cpu:
        runtime.force_cpu()
    runtime.enable_compilation_cache()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from coxgraph_tpu.frontends import loop_detector as ld
    from coxgraph_tpu.frontends import synthetic as syn
    from coxgraph_tpu.ops import features as ft

    print(f"backend: {jax.default_backend()}")
    fcfg = ft.FeatureConfig(max_keypoints=384)
    K = fcfg.max_keypoints
    cap, B = args.pool, args.batch
    rng = np.random.default_rng(0)

    # synthetic DB at the endurance fill level
    db_desc = jnp.asarray(
        rng.integers(0, 2**32, (cap, K, ft._N_WORDS), dtype=np.uint32))
    db_valid = jnp.asarray(
        np.arange(cap)[:, None] < args.fill)[..., 0][:, None] & \
        jnp.asarray(rng.random((cap, K)) < 0.9)
    db_pcam = jnp.asarray(rng.normal(0, 1, (cap, K, 3)).astype(np.float32))
    db_hdep = jnp.asarray(rng.random((cap, K)) < 0.8)
    elig_b = jnp.asarray(
        np.tile(np.arange(cap) < args.fill, (B, 1)))

    # real rendered frames (endurance cache if present, else render)
    intr = syn.PinholeIntrinsics().scaled(0.25)
    scene = syn.default_scene()
    traj = syn.orbit_trajectory(B, scene.room_center, radius=2.4)
    frames = [syn.render_depth(scene, intr, traj[i]) for i in range(B)]
    depths = jnp.stack([f[0] for f in frames])
    colors = jnp.stack([f[1] for f in frames])

    def timed(name, fn):
        out = fn()
        jax.block_until_ready(out)          # compile
        ts = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            out = fn()
            jax.block_until_ready(out)
            ts.append(time.perf_counter() - t0)
        best = min(ts)
        print(f"{name:28s} best {best * 1e3:8.1f} ms   "
              f"median {sorted(ts)[len(ts) // 2] * 1e3:8.1f} ms")
        return out

    kps = timed("detect_batch (B frames)", lambda: ld._detect_batch(
        intr, colors, depths, fcfg))

    key = jax.random.PRNGKey(0)
    timed("match+verify_batch", lambda: ld._match_and_verify_batch(
        db_desc, db_valid, db_pcam, db_hdep, elig_b, kps,
        fcfg, 2, args.chunk, key))

    # isolate the two halves of the fused program
    def score_only():
        def one(q_valid, q_desc):
            qkp = ft.Keypoints(uv=None, response=None, valid=q_valid,
                               desc=q_desc, p_cam=None, has_depth=None)
            return _score(db_desc, db_valid, qkp)
        return jax.vmap(one)(kps.valid, kps.desc)

    import functools

    @functools.partial(jax.jit, static_argnums=())
    def _score(dd, dv, q):
        nc = -(-cap // args.chunk)
        pad = nc * args.chunk - cap

        def count_chunk(a):
            desc_c, valid_c = a

            def one(desc_b, valid_b):
                aa = ft.Keypoints(uv=None, response=None, valid=q.valid,
                                  desc=q.desc, p_cam=None, has_depth=None)
                bb = ft.Keypoints(uv=None, response=None, valid=valid_b,
                                  desc=desc_b, p_cam=None, has_depth=None)
                mb, _ = ft.match_descriptors(aa, bb, fcfg)
                return (mb >= 0).sum()
            return jax.vmap(one)(desc_c, valid_c)

        ddp = jnp.pad(dd, ((0, pad), (0, 0), (0, 0)))
        dvp = jnp.pad(dv, ((0, pad), (0, 0)))
        return jax.lax.map(
            count_chunk, (ddp.reshape(nc, args.chunk, K, -1),
                          dvp.reshape(nc, args.chunk, K))).reshape(-1)[:cap]

    timed("  score half (B queries)", score_only)

    def verify_only():
        keys = jax.random.split(key, B * 2).reshape(B, 2, -1)

        @jax.jit
        def go(kps, keys):
            def one(q, ks):
                def v(idx, sk):
                    kf = ft.Keypoints(uv=None, response=None,
                                      valid=db_valid[idx],
                                      desc=db_desc[idx],
                                      p_cam=db_pcam[idx],
                                      has_depth=db_hdep[idx])
                    return ft.estimate_relative_pose(
                        kf, q, fcfg, key=sk, return_spread=True)
                return jax.vmap(v)(jnp.arange(2), ks)
            return jax.vmap(one)(kps, keys)
        return go(kps, keys)

    timed("  verify half (B x 2 cand)", verify_only)

    slots = jnp.arange(B, dtype=jnp.int32) + args.fill
    timed("db_append_batch", lambda: ld._db_append_batch(
        jnp.copy(db_desc), jnp.copy(db_valid), jnp.copy(db_pcam),
        jnp.copy(db_hdep), kps, slots))


if __name__ == "__main__":
    main()
