"""K1-K5b at any joint count and on branched trees, on the CPU.

- `ops/_build.py` builds one library per joint count: its flags carry
  `-DAG_NJ=<nj>`, its path is content-addressed per count, and
  `build_many` starts every source of every count asked for (pure Python,
  no nvcc).
- The kernels' shared memory: `cuda_dynamics.smem_bytes` equals the
  header's `ag::smem_floats` (through the g++ harness, per joint count);
  the one refusal left on the card is a block past the card's opt-in, with
  its bytes; `select_backend` on the card takes "kernels" for a 3-joint arm
  and the full 17-DoF Tiago-Pro, and "xla" (with the bytes) only past it.
- The plain K1-K4 against the JAX package's Pallas bodies
  (`_item_terms_c` + `dynamics_terms`, assembled as `test_torch_stage.py`
  assembles them) on the full Tiago-Pro (branched: the head and both arms
  hang off the prismatic torso) with the bimanual spec
  `chip_smoke.tiago_full_spec`, and the plain K5a/K5b against the JAX
  Pallas step body, f64: x+ and l atol 1e-10, every derivative atol 1e-8,
  rtol 1e-8.
- The full Tiago-Pro's tick at T = 4 on the "kernels" backend (K1-K4's
  plain versions) against the "xla" backend (K5a/K5b's and the batched
  cost pack), iterate for iterate at 1e-8; under `-m slow`, the "kernels"
  `BatchSQP` against the JAX `make_batch_sqp` over its generic cost
  functions (the JAX XLA cost pack drops the prismatic torso's Jacobian
  column, ROADMAP queue 3), iterate for iterate at 1e-8 with equal
  iteration counts.
"""

import dataclasses
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as smoke
from agimus_controller_tpu.models import tiago_pro as jtiago
from agimus_controller_tpu.ocp import spec as jspec
from agimus_controller_tpu.ocp.costs import build_cost_functions as jax_build_cf
from agimus_controller_tpu.ops import kinematics as jkin
from agimus_controller_tpu.ops import pallas_costs as jpc
from agimus_controller_tpu.ops.batched_dynamics import _StaticModel as JaxStaticModel
from agimus_controller_tpu.ops.pallas_dynamics import dynamics_terms as jax_dynamics_terms
from agimus_controller_tpu.solver.csqp import CSQPSettings as JaxSettings
from agimus_controller_tpu.solver.sqp_batch import make_batch_sqp as jax_batch_sqp
from agimus_controller_tpu_torch.models.model import params_from_numpy
from agimus_controller_tpu_torch.models.urdf import build_model_from_urdf
from agimus_controller_tpu_torch.ocp.spec import (
    CostItem,
    ProblemSpec,
    refs_from_numpy,
)
from agimus_controller_tpu_torch.ops import _build, cuda_costs, cuda_dynamics
from agimus_controller_tpu_torch.ops.cuda_dynamics import StepKernel
from agimus_controller_tpu_torch.solver.csqp import CSQPSettings
from agimus_controller_tpu_torch.solver.sqp_batch import (
    make_batch_sqp,
    select_backend,
)
from tests._torch_lanes_lib import HostLibs
from tests.test_torch_fallback import URDF_3DOF, _goal_spec
from tests.test_torch_stage import to_jax_spec

CPU = torch.device("cpu")
CUDA = torch.device("cuda")
STAGE_OUT = smoke.STAGE_OUT
TERM_OUT = ("l", "lx", "lxx")
N = 6  # nodes of the JAX comparisons


# ---------------------------------------------------------------------------
# the per-count build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nj", [2, 3, 7, 8, 17])
def test_library_per_joint_count(nj):
    """Each count its flags (the shared ones and -DAG_NJ) and its own
    content-addressed library, named after the count."""
    flags = _build.nvcc_flags(nj)
    assert flags[:len(_build.NVCC_FLAGS)] == _build.NVCC_FLAGS
    assert flags[len(_build.NVCC_FLAGS):] == (f"-DAG_NJ={nj}",)
    path = _build.library_path(nj)
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith(f"libagimus_kernels_nj{nj}_")
    assert path == _build.library_path(nj)
    others = {_build.library_path(n) for n in (2, 3, 7, 8, 17) if n != nj}
    assert path not in others


def test_library_path_follows_sources_and_flags(monkeypatch, tmp_path):
    """The hash covers the sources and the flags: an edited source or flag
    is a new library."""
    before = _build.library_path(17)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-g",))
    assert _build.library_path(17) != before
    monkeypatch.undo()
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert _build.library_path(17).name == before.name
    (csrc / "stage_kernels.cuh").write_text(
        (csrc / "stage_kernels.cuh").read_text() + "\n// edited\n")
    assert _build.library_path(17).name != before.name
    with pytest.raises(ValueError):
        _build.nvcc_flags(0)


def test_build_many_starts_every_source_at_once(monkeypatch, tmp_path):
    """`build_many` starts one compiler per source and count before it
    waits on any, links each count's objects into its library and skips a
    count whose library is there; the compilers' output comes back per
    count."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    started, waited = [], []

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kw):
            assert not waited, "a compiler started after the first wait"
            started.append(cmd)
            self.cmd = cmd

        def communicate(self):
            waited.append(self.cmd)
            return f"ptxas {self.cmd[-1]}\n", None

    def link(cmd, **kw):
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"lib")
        return type("Done", (), {"returncode": 0, "stderr": ""})()

    monkeypatch.setattr(_build.subprocess, "Popen", Proc)
    monkeypatch.setattr(_build.subprocess, "run", link)
    _build.library_path(8).write_bytes(b"there")
    built = _build.build_many([17, 8, 3])
    sources = sorted(_build.CSRC.glob("*.cu"))
    assert len(started) == 2 * len(sources)
    assert sorted(c[c.index("-c") - 1] for c in started) == sorted(
        ["-DAG_NJ=17"] * len(sources) + ["-DAG_NJ=3"] * len(sources))
    assert [p for p, _ in built] == [_build.library_path(n)
                                     for n in (17, 8, 3)]
    assert all(p.is_file() for p, _ in built)
    assert built[1][1] == "" and all(
        str(src) in built[0][1] for src in sources)
    assert not list(tmp_path.glob("*.o"))


# ---------------------------------------------------------------------------
# shared memory: the one refusal left
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels' host harness")
    return HostLibs(tmp_path_factory.mktemp("joint_counts"))


@pytest.mark.parametrize("nj", [2, 7, 8, 17, 31])
def test_smem_bytes_match_the_header(host_lib, nj):
    lib = host_lib.lib(nj)
    for name, kid in cuda_dynamics.KERNEL_IDS.items():
        for consts_len, width, n_items in ((31 * nj + 3, 0, 0),
                                           (31 * nj + 3 + 3 * 84, 121, 3),
                                           (1001, 37, 7)):
            want = 4 * lib.ag_smem_floats_host(kid, consts_len, width,
                                               n_items)
            if not name.startswith("K5"):
                want += cuda_dynamics.REF_TABLE_BYTES
            assert cuda_dynamics.smem_bytes(name, nj, consts_len, width,
                                            n_items) == want, (name, nj)


def _chain_urdf(n):
    """A serial chain of n revolute joints (the tip link carries the frame
    'tip')."""
    inertial = ('<inertial><origin xyz="0 0 0.05"/><mass value="0.5"/>'
                '<inertia ixx="0.01" iyy="0.01" izz="0.01" ixy="0" ixz="0" '
                'iyz="0"/></inertial>')
    body = ['<?xml version="1.0"?><robot name="chain">',
            f'<link name="l0">{inertial}</link>']
    for i in range(1, n + 1):
        body.append(
            f'<joint name="j{i}" type="revolute"><parent link="l{i - 1}"/>'
            f'<child link="l{i}"/><origin xyz="0 0 0.1"/>'
            f'<axis xyz="{"0 1 0" if i % 2 else "1 0 0"}"/><limit '
            'effort="50" lower="-3" upper="3" velocity="3"/></joint>'
            f'<link name="l{i}">{inertial}</link>')
    body.append(f'<joint name="jt" type="fixed"><parent link="l{n}"/>'
                 '<child link="tip"/><origin xyz="0 0 0.1"/></joint>'
                 '<link name="tip"/></robot>')
    return "".join(body)


def test_refusal_states_its_bytes():
    """K5b's block passes the card's opt-in from 31 joints on, K1's from 44
    (a goal and a state item): the stage kernels refuse such a spec with
    the bytes ("auto" takes "xla"), the step kernels' wrapper too; below it
    nothing is refused."""
    for nj in (17, 30):
        cuda_dynamics.check_smem("K5b", nj, 31 * nj + 3)
    need = cuda_dynamics.smem_bytes("K5b", 31, 31 * 31 + 3)
    assert need > cuda_dynamics.SMEM_OPTIN_BYTES
    with pytest.raises(NotImplementedError, match=f"needs {need} bytes"):
        cuda_dynamics.check_smem("K5b", 31, 31 * 31 + 3)
    model, _ = build_model_from_urdf(_chain_urdf(48), dtype=torch.float64,
                                     device="cpu")
    backend, why = select_backend(model, _goal_spec("tip"), CUDA)
    assert backend == "xla" and "K1 at nj=48" in why and "bytes" in why
    assert select_backend(model, _goal_spec("tip"), CPU) == ("kernels", None)


def test_any_joint_count_takes_the_kernels_on_the_card():
    """"auto" on the card: the 3-joint arm, the 4-joint Tiago-Pro chain and
    the full 17-DoF Tiago-Pro take K1-K4."""
    arm3, _ = build_model_from_urdf(URDF_3DOF, dtype=torch.float64,
                                    device="cpu")
    full, _ = jtiago.load_tiago_pro(moving_joint_names="all",
                                    dtype=np.float64)
    chain4, _ = jtiago.load_tiago_pro(moving_joint_names=CHAIN4,
                                      dtype=np.float64)
    for model, spec in ((arm3, _goal_spec("tip")),
                        (full, smoke.tiago_full_spec(20)),
                        (chain4, smoke.tiago_spec(20))):
        assert select_backend(model, spec, CUDA) == ("kernels", None)


# the 4-joint Tiago-Pro chain of the lane tests: the torso and the left
# arm's first three joints
CHAIN4 = ["torso_lift_joint", "left_arm_1_joint", "left_arm_2_joint",
          "left_arm_3_joint"]


# ---------------------------------------------------------------------------
# the plain K1-K5b against the JAX Pallas bodies on the full Tiago-Pro
# ---------------------------------------------------------------------------

def jax_eval(jm, jp, js, items, refs, x, u, t_idx, dts, running):
    """The Pallas kernel bodies on (1, N) component arrays, f64: the cost
    items' Gauss-Newton terms (dt-scaled where running) and, where
    running, `dynamics_terms` with derivatives."""
    nj, n = jm.nj, x.shape[0]
    nx = 2 * nj
    sm = JaxStaticModel(jm, jp)
    layout = jpc._ref_layout(js, jm, items)
    offsets, _ = jpc._slice_layout(layout)
    rows = jpc.gather_node_refs(
        layout, jpc._with_geom_defaults(layout, refs, jp, jnp.float64),
        jnp.asarray(t_idx), n, jnp.float64)

    def rget(key, default="raise"):
        off, ncomp = offsets[key]
        return [rows[off + i][None] for i in range(ncomp)]

    q = [jnp.asarray(x[:, i][None]) for i in range(nj)]
    v = [jnp.asarray(x[:, nj + i][None]) for i in range(nj)]
    uc = ([jnp.asarray(u[:, i][None]) for i in range(nj)] if running
          else [jnp.zeros((1, n))] * nj)
    acc = {"l": 0.0, "lx": [None] * nx, "lu": [None] * nj,
           "lxx": [None] * nx * nx, "lxu": [None] * nx * nj, "lu_": None,
           "luu": [None] * nj * nj}
    for item in items:
        jpc._item_terms_c(item, jm, jp, sm, q, v, uc, rget, True,
                          float(item.weight), acc)
    ones = jnp.ones((1, n))
    dense = lambda comps, shape: np.stack(
        [np.asarray((0.0 if c is None else c) * ones)[0] for c in comps],
        1).reshape((n,) + shape)
    scale = dts if running else np.ones(n)
    sc = lambda a: a * scale.reshape((n,) + (1,) * (a.ndim - 1))
    out = {"l": sc(np.asarray(acc["l"] * ones)[0]),
           "lx": sc(dense(acc["lx"], (nx,))),
           "lxx": sc(dense(acc["lxx"], (nx, nx)))}
    if running:
        xn, fx, fu = jax_dynamics_terms(sm, q, v, uc, jnp.asarray(dts[None]),
                                        True)
        out.update(xnext=dense(xn, (nx,)), Fx=dense(fx, (nx, nx)),
                   Fu=dense(fu, (nx, nj)), lu=sc(dense(acc["lu"], (nj,))),
                   lxu=sc(dense(acc["lxu"], (nx, nj))),
                   luu=sc(dense(acc["luu"], (nj, nj))))
    return out


def _tol(name):
    return (1e-10, 0.0) if name in ("xnext", "l") else (1e-8, 1e-8)


@pytest.fixture(scope="module")
def full_case():
    """The plain K1-K5b and the JAX bodies on the same N nodes of the full
    Tiago-Pro, f64, around its ready pose with v and u live."""
    jm, jp = jtiago.load_tiago_pro(moving_joint_names="all",
                                   dtype=np.float64)
    assert jm.nj == 17 and tuple(jm.parents) != tuple(range(-1, 16))
    p = params_from_numpy(jp, dtype=torch.float64, device="cpu")
    ps = smoke.tiago_full_spec(4)
    js = to_jax_spec(ps)
    refs, x, u, _, t_idx = smoke.tiago_inputs(ps, jm, N, 3, CPU,
                                              smoke.tiago_full_ready())
    refs = {k: v.double().numpy() for k, v in refs.items()}
    x, u, t_idx = x.double().numpy(), u.double().numpy(), t_idx.numpy()
    dts = np.asarray(js.timesteps())[t_idx]
    jrefs = {k: jnp.asarray(v) for k, v in refs.items()}
    want = {"stage": jax_eval(jm, jp, js, js.running_costs, jrefs, x, u,
                              t_idx, dts, True),
            "term": jax_eval(jm, jp, js, js.terminal_costs, jrefs, x, u,
                             np.full(N, 4), dts, False)}
    # the step's body is the stage body's `dynamics_terms`
    want["step1"] = tuple(want["stage"][k] for k in ("xnext", "Fx", "Fu"))
    want["step0"] = want["step1"][:1]
    tt = torch.as_tensor
    args = (tt(x), tt(u), tt(dts), tt(t_idx), refs_from_numpy(refs,
                                                               device="cpu"))
    got = {"stage": dict(zip(STAGE_OUT, cuda_costs.make_cuda_stage(
        jm, p, ps, True, CPU)(*args))),
           "stage_v": dict(zip(("xnext", "l"), cuda_costs.make_cuda_stage(
               jm, p, ps, False, CPU)(*args))),
           "term": dict(zip(TERM_OUT, cuda_costs.make_cuda_terminal(
               jm, p, ps, True, CPU)(args[0], args[4]))),
           "term_v": cuda_costs.make_cuda_terminal(jm, p, ps, False, CPU)(
               args[0], args[4])[0]}
    for derivs in (True, False):
        out = StepKernel(jm, p, derivs, CPU).plain(*args[:3])
        got[f"step{int(derivs)}"] = out if derivs else (out,)
    return got, want


@pytest.mark.parametrize("out", STAGE_OUT)
def test_full_tiago_k1_matches_pallas_body(full_case, out):
    got, want = full_case
    atol, rtol = _tol(out)
    np.testing.assert_allclose(got["stage"][out].numpy(),
                               want["stage"][out], atol=atol, rtol=rtol)


@pytest.mark.parametrize("out", ("xnext", "l"))
def test_full_tiago_k2_matches_pallas_body(full_case, out):
    got, want = full_case
    np.testing.assert_allclose(got["stage_v"][out].numpy(),
                               want["stage"][out], atol=1e-10, rtol=0)


@pytest.mark.parametrize("out", TERM_OUT)
def test_full_tiago_k3_matches_pallas_body(full_case, out):
    got, want = full_case
    atol, rtol = _tol(out)
    np.testing.assert_allclose(got["term"][out].numpy(), want["term"][out],
                               atol=atol, rtol=rtol)


def test_full_tiago_k4_matches_pallas_body(full_case):
    got, want = full_case
    np.testing.assert_allclose(got["term_v"].numpy(), want["term"]["l"],
                               atol=1e-10, rtol=0)


@pytest.mark.parametrize("derivs", [True, False], ids=["K5b", "K5a"])
def test_full_tiago_step_matches_pallas_body(full_case, derivs):
    got, want = full_case
    key = f"step{int(derivs)}"
    for name, g, w in zip(("xnext", "Fx", "Fu"), got[key], want[key]):
        atol, rtol = _tol(name)
        np.testing.assert_allclose(g.numpy(), w, atol=atol, rtol=rtol,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the full Tiago-Pro's tick
# ---------------------------------------------------------------------------

T = 4
SETTINGS = dict(max_iters=10, termination_tolerance=1e-6, reg_init=1e-7)


def _tick_problem():
    """The bimanual OCP on the full Tiago-Pro at T = 4 (JAX and port
    specs), each tool's target `chip_smoke.tiago_goal` away, B = 2 starts
    around `chip_smoke.tiago_full_ready`, the gravity torque as us."""
    from agimus_controller_tpu.ops import dynamics as jdyn

    jm, jp = jtiago.load_tiago_pro(moving_joint_names="all",
                                   dtype=np.float64)
    pp = params_from_numpy(jp, dtype=torch.float64, device="cpu")
    # a dt f32 holds exactly: the cost pack scales by a float32 copy of it
    ps = dataclasses.replace(smoke.tiago_full_spec(T), dt=2.0 ** -6)
    js = to_jax_spec(ps)
    q0 = smoke.tiago_full_ready()
    x0 = np.concatenate([q0, np.zeros(17)])
    refs = jspec.default_references(js, jm, dtype=jnp.float64)
    refs["xref"] = jnp.tile(x0[None], (T + 1, 1))
    for frame in smoke.TIAGO_FULL_FRAMES:
        p0 = np.asarray(jkin.frame_placement(
            jm, jp, jnp.asarray(q0), jm.frame_id(frame))[1])
        refs[f"ee_trans:{frame}"] = jnp.tile(
            (p0 + smoke.tiago_goal(frame))[None], (T + 1, 1))
    rng = np.random.default_rng(0)
    x0s = np.tile(x0[None], (2, 1))
    x0s[1, :17] += rng.normal(size=17) * 0.02
    tau_g = np.asarray(jdyn.generalized_gravity(jm, jp, jnp.asarray(q0)))
    return dict(jm=jm, jp=jp, pp=pp, js=js, ps=ps, refs=refs, x0s=x0s,
                xs=np.tile(x0[None, None], (2, T + 1, 1)),
                us=np.tile(tau_g[None, None], (2, T, 1)))


def _port_solve(pr, backend, max_iters):
    solver = make_batch_sqp(pr["jm"], pr["pp"], pr["ps"], CSQPSettings(
        **dict(SETTINGS, max_iters=max_iters)), device="cpu", backend=backend)
    assert solver.backend == ("kernels" if backend == "auto" else backend)
    t = torch.as_tensor
    return solver(t(pr["x0s"]), refs_from_numpy(pr["refs"], device="cpu"),
                  t(pr["xs"]), t(pr["us"]))


def test_full_tiago_tick_backends_agree():
    """Tier-1 beside the slow JAX comparison: on the full Tiago-Pro the
    "kernels" backend (K1-K4's plain versions, nj = 17) and the "xla"
    backend (K5a/K5b's plain versions and the batched cost pack) take the
    same iterates."""
    pr = _tick_problem()
    a, b = _port_solve(pr, "auto", 2), _port_solve(pr, "xla", 2)
    for f in ("xs", "us", "K", "k", "cost", "kkt", "gap_norm"):
        np.testing.assert_allclose(getattr(a, f).numpy(),
                                   getattr(b, f).numpy(), rtol=0, atol=1e-8,
                                   err_msg=f)
    np.testing.assert_array_equal(a.iters.numpy(), b.iters.numpy())
    assert int(a.iters.min()) == 2


@pytest.mark.slow
def test_full_tiago_tick_matches_jax(monkeypatch):
    """The bimanual OCP on the full Tiago-Pro through the port's
    `BatchSQP` (K1-K4's plain versions, nj = 17) against the JAX batch SQP
    over its generic cost functions (its XLA cost pack drops the prismatic
    torso's constant Jacobian column, ROADMAP queue 3), B = 2."""
    from agimus_controller_tpu.solver import sqp_batch as jax_sqp_module

    monkeypatch.setattr(jax_sqp_module, "make_batched_cost_pack",
                        lambda *a, **k: None)
    pr = _tick_problem()
    jm, jp, js = pr["jm"], pr["jp"], pr["js"]
    want = jax.jit(jax_batch_sqp(jm, jp, js, jax_build_cf(
        jm, jp, js, dtype=jnp.float64), JaxSettings(**SETTINGS)))(
        jnp.asarray(pr["x0s"]), pr["refs"], jnp.asarray(pr["xs"]),
        jnp.asarray(pr["us"]))
    got = _port_solve(pr, "auto", SETTINGS["max_iters"])
    for f in ("xs", "us", "K", "k", "cost", "kkt", "gap_norm"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-8, err_msg=f)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    assert int(got.iters.min()) >= 2


def test_bimanual_ref_layout_fits_the_table():
    """The bimanual spec's ref layout at nj = 17: eight keys, xref and w_x
    34 wide, within the by-value table (`MAX_REFS`)."""
    jm, jp = jtiago.load_tiago_pro(moving_joint_names="all",
                                   dtype=np.float64)
    p = params_from_numpy(jp, dtype=torch.float32, device="cpu")
    k = cuda_costs.make_cuda_stage(jm, p, smoke.tiago_full_spec(20), True,
                                   CPU)
    assert len(k.layout) == 8 <= cuda_costs.MAX_REFS
    assert dict((key, n) for key, n, _ in k.layout)["xref"] == 34
    assert k.width == 2 * 34 + 2 * (9 + 3 + 6)
