"""Every f32 contraction whose result feeds a tolerance asks for HIGHEST
precision: the default lets GPU tensor cores round f32 operands to TF32
(10 mantissa bits). conftest.py sets a process-wide "highest" default for
the suite, so these tests read jaxprs traced under JAX's own default,
not results."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from coxgraph_tpu.core import geometry as geo, voxel as vx
from coxgraph_tpu.ops import features as ft
from coxgraph_tpu.ops import mesh as mesh_ops
from coxgraph_tpu.solver import pose_graph as pg


CONTRACTIONS = ("dot_general", "conv_general_dilated")


def _sub_jaxprs(value):
    if hasattr(value, "eqns"):
        yield value
    elif hasattr(value, "jaxpr") and hasattr(value, "consts"):
        yield value.jaxpr
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def f32_dot_precisions(jaxpr):
    """Precision params of every dot_general and conv_general_dilated
    with an f32 operand, in this jaxpr and every jaxpr nested in it."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in CONTRACTIONS and any(
                v.aval.dtype == jnp.float32 for v in eqn.invars):
            out.append(eqn.params["precision"])
        for p in eqn.params.values():
            for sub in _sub_jaxprs(p):
                out.extend(f32_dot_precisions(sub))
    return out


def _is_highest(precision) -> bool:
    hi = jax.lax.Precision.HIGHEST
    if isinstance(precision, (tuple, list)):
        return len(precision) == 2 and all(p == hi for p in precision)
    return precision == hi


def _pose_graph():
    poses = geo.se3_exp(jnp.asarray(
        np.random.default_rng(0).normal(0, 0.1, (4, 6)), jnp.float32))
    c = pg.RelPoseConstraints.empty(6)
    for i, j in ((0, 1), (1, 2), (2, 3), (3, 0)):
        c = c.add(i, j, geo.relative(poses[i], poses[j]), jnp.eye(6))
    return poses, c


def _normal_equations():
    poses, c = _pose_graph()
    return jax.make_jaxpr(lambda p: pg._build_normal_equations(
        p, c, pg.SolverConfig(), jnp.zeros((4,), bool)))(poses)


def _optimize():
    poses, c = _pose_graph()
    return jax.make_jaxpr(lambda p: pg.optimize(
        p, c, pg.SolverConfig(iterations=2)).poses)(poses)


def _kabsch():
    p = jnp.ones((16, 3))
    return jax.make_jaxpr(ft._kabsch)(p, p + 1.0, jnp.ones((16,)))


def _mesh_block_chunk():
    spec = vx.VoxelGridSpec(voxel_size=0.1, voxels_per_side=4, grid_dim=8,
                            max_blocks=16, truncation=0.3)
    layer = vx.create_tsdf_layer(spec)
    return jax.make_jaxpr(lambda l, s: mesh_ops.mesh_block_chunk(
        spec, l, s))(layer, jnp.arange(4, dtype=jnp.int32))


CASES = {
    "pose_graph_normal_equations": _normal_equations,
    "pose_graph_optimize": _optimize,
    "se3_exp": lambda: jax.make_jaxpr(geo.se3_exp)(jnp.ones((5, 6))),
    "se3_log": lambda: jax.make_jaxpr(geo.se3_log)(
        geo.se3_exp(jnp.ones((5, 6)) * 0.1)),
    "kabsch": _kabsch,
    "harris_response": lambda: jax.make_jaxpr(ft.harris_response)(
        jnp.ones((12, 16))),
    "mesh_block_chunk": _mesh_block_chunk,
}


def traced(name):
    """CASES[name]'s jaxpr, traced without conftest's "highest" default."""
    with jax.default_matmul_precision("default"):
        return CASES[name]()


@pytest.mark.parametrize("name", sorted(CASES))
def test_f32_contractions_ask_for_highest(name):
    closed = traced(name)
    precisions = f32_dot_precisions(closed.jaxpr)
    bad = [p for p in precisions if not _is_highest(p)]
    assert not bad, f"{name}: {len(bad)} of {len(precisions)} f32 " \
        f"dot_generals without HIGHEST: {bad[:3]}"
    assert precisions, f"{name}: expected f32 contractions"


def test_mesher_table_lookups_are_one_hot_matmuls():
    """The mesher's 9 table lookups (3 sdf-corner, 6 colour-corner) plus
    the edge-selection and triangle-count lookups are one-hot matmuls,
    all at HIGHEST."""
    precisions = f32_dot_precisions(traced("mesh_block_chunk").jaxpr)
    assert len(precisions) == 11 and all(map(_is_highest, precisions))


def test_walker_sees_a_default_precision_contraction():
    with jax.default_matmul_precision("default"):
        closed = jax.make_jaxpr(lambda a: jax.jit(jnp.dot)(a, a))(
            jnp.ones((3, 3)))
    precisions = f32_dot_precisions(closed.jaxpr)
    assert len(precisions) == 1 and not _is_highest(precisions[0])
