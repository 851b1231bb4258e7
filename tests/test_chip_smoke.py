"""chip_smoke.py without a GPU, and its comparison helpers: the smoke
must fail loudly off the card, and its checks must reject a wrong
answer."""

import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from coxgraph_tpu.core import voxel as vx
from coxgraph_tpu.frontends import synthetic as syn
from coxgraph_tpu.ops import features as ft
from coxgraph_tpu.ops import tsdf as tsdf_ops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = vx.VoxelGridSpec(voxel_size=0.1, voxels_per_side=8, grid_dim=32,
                        max_blocks=512, truncation=0.3)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_smoke_fails_without_gpu(where, tmp_path):
    """Under JAX_PLATFORMS=cpu, and in a directory holding only the
    script, it exits non-zero and prints no result line."""
    if where == "repo":
        script, cwd = os.path.join(ROOT, "chip_smoke.py"), ROOT
    else:
        script = shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


INTR = syn.PinholeIntrinsics().scaled(0.125)
CAM = np.asarray(syn.orbit_trajectory(
    1, syn.default_scene().room_center, radius=2.5)[0])


def _obs_weight(centers):
    # the layer is integrated in the world frame from the camera CAM
    return cs.observation_weights(INTR, CAM[None], centers)


@pytest.fixture(scope="module")
def layer():
    scene = syn.default_scene()
    d, c = syn.render_depth(scene, INTR, jnp.asarray(CAM))
    out = tsdf_ops.integrate_frame(
        SPEC, tsdf_ops.TsdfIntegratorConfig(max_touched_blocks=256), INTR,
        vx.create_tsdf_layer(SPEC), d, c, jnp.asarray(CAM))
    return jax.tree.map(np.asarray, out)


def _perturb_sdf(layer):
    sdf = layer.sdf.copy()
    rows = np.nonzero((layer.weight > 0).any(axis=1))[0]
    sdf[rows[::10]] += 1e-3           # 10 % of the observed blocks
    return dataclasses.replace(layer, sdf=sdf)


def _perturb_weight(layer):
    return dataclasses.replace(layer, weight=layer.weight * 1.1)


def _perturb_tail(layer):
    """2e-4 of the observed voxels 3 cm off: inside the share gate, past
    the tail quantile."""
    sdf = layer.sdf.copy()
    rows, cols = np.nonzero(layer.weight > 0)
    pick = np.random.default_rng(0).choice(
        len(rows), max(1, len(rows) // 5000), replace=False)
    sdf[rows[pick], cols[pick]] += 0.03
    return dataclasses.replace(layer, sdf=sdf)


def _extra_block(layer):
    out = vx.allocate_blocks(SPEC, jax.tree.map(jnp.asarray, layer),
                             jnp.asarray([[3, 3, 3]], jnp.int32))
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("perturb", [_perturb_sdf, _perturb_weight,
                                     _extra_block, _perturb_tail])
def test_layer_agreement_rejects_perturbed_layer(layer, perturb):
    assert int(layer.num_blocks) > 0
    rep = cs.Report()
    cs.check_layer_agreement(rep, "same", cs.layer_agreement(
        SPEC, layer, layer, _obs_weight))
    assert rep.failed == []
    agree = cs.layer_agreement(SPEC, layer, perturb(layer), _obs_weight)
    cs.check_layer_agreement(rep, "perturbed", agree)
    assert rep.failed and all(f.startswith("None: perturbed")
                              for f in rep.failed)
    if perturb is _perturb_tail:
        assert agree["frac_within"] >= cs.MIN_SHARE
        assert rep.failed == ["None: perturbed q99.99 |dsdf| m"]


def test_observation_weights():
    """1/max(z², 1) at the camera depth of a point the camera sees, the
    mean over the cameras that see it, the lightest where none does."""
    intr = syn.PinholeIntrinsics()
    eye = np.asarray([1, 0, 0, 0, 0, 0, 0], np.float64)
    back = eye.copy()
    back[6] = -2.0                      # 2 m further back along z
    pts = np.asarray([[0.0, 0.0, 2.0],  # on the axis: z 2 and 4
                      [0.0, 0.0, 0.5],  # z 0.5 → clamped to 1; and 2.5
                      [0.0, 0.0, -5.0]])  # behind both cameras
    w = cs.observation_weights(intr, np.stack([eye, back]), pts)
    np.testing.assert_allclose(w[0], (1 / 4 + 1 / 16) / 2)
    np.testing.assert_allclose(w[1], (1.0 + 1 / 6.25) / 2)
    np.testing.assert_allclose(w[2], 1 / 25)
    w1 = cs.observation_weights(intr, eye[None], pts[:1])
    np.testing.assert_allclose(w1, [1 / 4])


def test_chain_relative_errors_ignore_a_rigid_motion_of_the_chain():
    """The solve's pair check sees a change of one link, not a motion of
    the whole chain."""
    from coxgraph_tpu.core import geometry as geo

    chain = np.stack([np.asarray(geo.from_xyzyaw(jnp.asarray(
        [0.8 * k, 0.0, 0.0, 0.01 * k]))) for k in range(8)])
    moved = geo.compose_np(np.asarray(geo.from_xyzyaw(jnp.asarray(
        [3.0, -1.0, 0.5, 0.3])))[None], chain)
    drot, dtr = cs.chain_relative_errors(chain, moved)
    assert drot < 1e-5 and dtr < 1e-5
    assert cs.pose_errors(chain, moved)[1] > 1.0
    bent = chain.copy()
    bent[5:, 4] += 2e-3                 # one link 2 mm longer
    drot, dtr = cs.chain_relative_errors(chain, bent)
    assert drot < 1e-5 and abs(dtr - 2e-3) < 1e-5


def test_pose_errors_measure_rotation_and_translation():
    a = np.tile(np.asarray([1, 0, 0, 0, 0, 0, 0], np.float32), (3, 1))
    b = a.copy()
    b[1, 4] += 2e-3                                   # 2 mm
    b[2, :4] = [np.cos(1e-3), 0, 0, np.sin(1e-3)]     # 2 mrad about z
    drot, dtr = cs.pose_errors(a, b)
    assert abs(dtr - 2e-3) < 1e-6
    assert abs(drot - 2e-3) < 1e-5


def test_popcount_reference_matches_hamming_matrix():
    rng = np.random.default_rng(3)
    da = rng.integers(0, 2 ** 32, (17, 8), dtype=np.uint32)
    db = rng.integers(0, 2 ** 32, (9, 8), dtype=np.uint32)
    want = cs.popcount_hamming(da, db)
    got = np.asarray(ft.hamming_matrix(jnp.asarray(da), jnp.asarray(db)))
    np.testing.assert_array_equal(got, want)
    assert want[0, 0] == sum(bin(int(x ^ y)).count("1")
                             for x, y in zip(da[0], db[0]))
