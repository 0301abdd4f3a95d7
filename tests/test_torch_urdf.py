"""The port's URDF loader (tpustomp_torch/robot/urdf_lite.py) against the
JAX package's: every inline URDF of tests/unit/test_urdf.py and
tests/unit/test_urdf_tree.py loads to the same spec (every tensor exactly,
body_counts, joint_static, rot_fixed_identity), the mesh sphere covers
agree, and plan_batch over a URDF robot with a prismatic joint and fixed
rotations matches JAX plan_batch under the replayed key chain.
"""

import dataclasses
import importlib.util
import os
import warnings

import jax
import numpy as np
import pytest

from tests.test_torch_cuda import TORSO_ARM_URDF as TORSO_ARM
from tests.test_torch_solver import _ReplayJaxNoise, _configs, _fields
from tpustomp.api.plan import plan_batch as j_plan_batch
from tpustomp.api.problem import ProblemSpec as JProblem
from tpustomp.robot import urdf_lite as jurdf
from tpustomp.world.sdf import AnalyticWorld as JWorld
from tpustomp_torch import ProblemSpec, convert, plan_batch
from tpustomp_torch.kernels import rollout as tr
from tpustomp_torch.robot import urdf_lite as turdf

_UNIT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "unit")


def _reference_test(name):
    """The reference's test module (for its URDF strings and mesh
    writers), loaded under a private name."""
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", os.path.join(_UNIT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_U = _reference_test("test_urdf")
_T = _reference_test("test_urdf_tree")

_RIGHT_ARM = dict(root="base", tip="r_gripper",
                  group_joints=["r_shoulder", "r_elbow"])
_CASES = {
    "planar_2r": ("load_urdf", (_U.PLANAR_2R,), {}),
    "fixed_chain": ("load_urdf", (_U.FIXED_CHAIN,), {}),
    "inertia_merge": ("load_urdf", (_U.INERTIA_MERGE,), {}),
    "two_arm_full_chain": ("load_urdf", (_T.TWO_ARM_URDF,),
                           dict(root="base", tip="r_gripper")),
    "two_arm_torso_root": ("load_urdf", (_T.TWO_ARM_URDF,),
                           dict(root="torso", tip="r_gripper")),
    "right_arm_group": ("load_urdf_group", (_T.TWO_ARM_URDF,),
                        dict(_RIGHT_ARM, fixed_positions={
                            "torso_lift": 0.2, "l_shoulder": np.pi / 2})),
    "right_arm_group_posed": ("load_urdf_group", (_T.TWO_ARM_URDF,),
                              dict(_RIGHT_ARM, fixed_positions={
                                  "torso_lift": 0.0, "l_shoulder": -0.8,
                                  "l_elbow": -0.2})),
    "torso_arm": ("load_urdf", (TORSO_ARM,), {}),
}


def _load_both(fn, args, kw):
    """(JAX result, port result, their warnings' messages)."""
    out, msgs = [], []
    for mod in (jurdf, turdf):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out.append(getattr(mod, fn)(*args, **kw))
        msgs.append([str(w.message) for w in caught])
    return out[0], out[1], msgs


def _assert_same_spec(jspec, tspec):
    for f in dataclasses.fields(jspec):
        j, t = getattr(jspec, f.name), getattr(tspec, f.name)
        if f.name in ("rot_fixed_identity", "body_counts", "joint_static"):
            assert t == j, f.name
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=f.name)
            assert t.dtype.itemsize == np.asarray(j).dtype.itemsize, f.name


@pytest.mark.parametrize("case", sorted(_CASES))
def test_urdf_spec_equals_jax(case):
    fn, args, kw = _CASES[case]
    j, t, msgs = _load_both(fn, args, kw)
    assert msgs[0] == msgs[1]
    if fn == "load_urdf_group":
        (j, j_static), (t, t_static) = j, t
        assert len(t_static) == len(j_static)
        for (tc, tr_), (jc, jr_) in zip(t_static, j_static):
            np.testing.assert_array_equal(tc, jc)
            assert tr_ == jr_
    _assert_same_spec(j, t)


def test_torso_arm_is_what_it_says():
    robot = turdf.load_urdf(TORSO_ARM)
    assert robot.joint_type.tolist() == [1, 0, 0, 0]
    assert not robot.rot_fixed_identity
    assert robot.body_counts == (3, 3, 4, 1)
    # a prismatic +z joint, a -1 component, general components
    assert tr.chain_of(robot) == (0, 1, 0, 0, 1, 3, 0, 0, -1, 0, 3,
                                  0, 2, 0, 2, 4, 0, 1, 0, 0, 1)


@pytest.mark.parametrize("writer,ext", [("_write_binary_stl", "stl"),
                                        ("_write_ascii_stl", "stl"),
                                        ("_write_obj", "obj")])
def test_mesh_sphere_cover_equals_jax(tmp_path, writer, ext):
    path = str(tmp_path / f"link.{ext}")
    getattr(_U, writer)(path, _U._box_triangles())
    j_pts = jurdf._load_mesh_points(path, np.ones(3))
    t_pts = turdf._load_mesh_points(path, np.ones(3))
    np.testing.assert_array_equal(t_pts, j_pts)
    j_sph = jurdf._spheres_from_points(j_pts)
    t_sph = turdf._spheres_from_points(t_pts)
    assert len(t_sph) == len(j_sph) >= (3 if ext == "stl" else 2)
    for (tc, tr_), (jc, jr_) in zip(t_sph, j_sph):
        np.testing.assert_array_equal(tc, jc)
        assert tr_ == jr_
    _U._assert_covers(t_sph, t_pts)


def test_urdf_mesh_geometry_equals_jax(tmp_path):
    _U._write_binary_stl(str(tmp_path / "arm.stl"), _U._box_triangles())
    urdf = """
    <robot name="meshbot">
      <link name="base"/>
      <link name="arm">
        <collision>
          <origin xyz="0 0 0.05" rpy="0 0 0.3"/>
          <geometry><mesh filename="package://meshbot/arm.stl"
                          scale="1 1 1"/></geometry>
        </collision>
      </link>
      <joint name="j1" type="revolute">
        <parent link="base"/><child link="arm"/>
        <origin xyz="0 0 0"/><axis xyz="0 0 1"/>
        <limit lower="-3" upper="3"/>
      </joint>
    </robot>
    """
    j, t, _ = _load_both("load_urdf", (urdf,), dict(mesh_dir=str(tmp_path)))
    assert t.num_bodies >= 3
    _assert_same_spec(j, t)


@pytest.mark.parametrize("urdf,kw,err", [
    ("<robot><link name='a'/><link name='b'/></robot>", {}, ValueError),
    ("""<robot name="m"><link name="base"/><link name="a">
      <collision><geometry><mesh filename="nope.stl"/></geometry></collision>
      </link><joint name="j" type="revolute"><parent link="base"/>
      <child link="a"/><axis xyz="0 0 1"/><limit lower="-1" upper="1"/>
      </joint></robot>""", "mesh_dir", FileNotFoundError),
])
def test_urdf_refusals_match_jax(tmp_path, urdf, kw, err):
    kw = {"mesh_dir": str(tmp_path)} if kw == "mesh_dir" else kw
    for mod in (jurdf, turdf):
        with pytest.raises(err):
            mod.load_urdf(urdf, **kw)


def test_plan_batch_urdf_robot_matches_jax():
    """The slice on the URDF torso arm (prismatic joint, fixed rotations, a
    general axis: the JAX kernel's static_joints folds all three) over a
    box and a sphere: B=3, N=20, K=8, 8 iterations, JAX's Pallas evaluator
    in interpret mode against the port's plain one on the CPU; tolerances
    as tests/test_torch_plan.py (trajectory 1e-4, cost rtol 1e-4)."""
    cj, ct = _configs()
    jr = jurdf.load_urdf(TORSO_ARM)
    robot = convert.robot_from_numpy(_fields(jr))
    jw = JWorld.make(boxes=[((0.5, 0.0, 0.2), (0.2, 0.4, 0.2))],
                     spheres=[((0.35, 0.25, 0.75), 0.1)])
    world = convert.world_from_numpy(_fields(jw))
    B = 3
    rng = np.random.default_rng(4)
    q0 = np.array([0.05, -0.4, -0.5, 0.0], np.float32)
    qN = np.array([0.2, 0.6, 0.5, 0.3], np.float32)
    q0b = (q0 + rng.uniform(-0.03, 0.03, (B, 4))).astype(np.float32)
    qNb = (qN + rng.uniform(-0.03, 0.03, (B, 4))).astype(np.float32)
    q0b[:, 0] = np.abs(q0b[:, 0])
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    ref = j_plan_batch(jr, jw, JProblem(q0=q0b, qN=qNb), cj, keys=keys)
    got = plan_batch(robot, world, ProblemSpec(q0=q0b, qN=qNb), ct,
                     device="cpu",
                     noise_fn=_ReplayJaxNoise(keys, 4, ct.num_rollouts,
                                              ct.num_timesteps))
    np.testing.assert_array_equal(got.success.numpy(),
                                  np.asarray(ref.success))
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(got.trajectory.numpy(),
                               np.asarray(ref.trajectory), atol=1e-4)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-4)
