"""The port's recorder, bag containers and checkpoints (`runtime/recorder.py`,
`runtime/bag_readers.py`, `runtime/checkpoint.py`) vs the JAX package.

Each file format is read across both packages in both directions: a
recording saved as npz, as a rosbag2-layout sqlite3 bag and as an mcap bag,
and a checkpoint, written by one package and read by the other, equal to
what the writer holds (the mcap files are equal byte for byte). The JAX
tests of these modules are mirrored on the port: the bag round trips, a
chunked mcap container (uncompressed and zstd; the lz4 branch raises
without `lz4`), the recorder's bag against its npz, the checkpoint round
trip with and without a solution and with every point and weight field,
and a resumed `MPC` against an uninterrupted one (the port only, the
ring-fed "sqp" `OCPTorch` on the 2-DoF arm in f64, controls at 1e-10).
"""

import struct

import numpy as np
import pytest
import torch

from agimus_controller_tpu.mpc import buffer as jbuffer
from agimus_controller_tpu.mpc.data import MPCDebugData as JaxDebug
from agimus_controller_tpu.mpc.data import OCPDebugData as JaxOCPDebug
from agimus_controller_tpu.mpc.data import OCPResults as JaxResults
from agimus_controller_tpu.mpc.mpc import MPC as JaxMPC
from agimus_controller_tpu.runtime import bag_readers as jbr
from agimus_controller_tpu.runtime import checkpoint as jckpt
from agimus_controller_tpu.runtime.recorder import MPCRecorder as JaxRecorder
from agimus_controller_tpu_torch.mpc.buffer import (
    DTFactorsNSeq,
    TrajectoryBuffer,
    TrajectoryPoint,
    TrajectoryPointWeights,
    WeightedTrajectoryPoint,
)
from agimus_controller_tpu_torch.mpc.data import (
    MPCDebugData,
    OCPDebugData,
    OCPResults,
)
from agimus_controller_tpu_torch.mpc.mpc import MPC
from agimus_controller_tpu_torch.runtime import MPCRecorder
from agimus_controller_tpu_torch.runtime import bag_readers as br
from agimus_controller_tpu_torch.runtime.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from tests.test_torch_mpc import (
    TorchUnicycleOCP,
    TorchUnicycleWarmStart,
    _port_point,
)

PKGS = {"jax": (JaxRecorder, JaxResults, JaxDebug, JaxOCPDebug),
        "port": (MPCRecorder, OCPResults, MPCDebugData, OCPDebugData)}


def _record(pkg, n=4, seed=1):
    """A recording of n ticks with named reference and residual streams,
    the same numbers in either package's recorder."""
    Rec, Res, Dbg, ODbg = PKGS[pkg]
    rng = np.random.default_rng(seed)
    rec = Rec()
    for k in range(n):
        res = Res(states=rng.normal(size=(11, 14)),
                  ricatti_gains=rng.normal(size=(10, 7, 14)),
                  feed_forward_terms=rng.normal(size=(10, 7)))
        dbg = Dbg(ocp=ODbg(
            result=[], references={"goal": rng.normal(size=(11, 3))},
            residuals={"goal": rng.normal(size=(10, 6)),
                       "state_reg": rng.normal(size=(10, 14))},
            kkt_norm=0.1 * k, nb_iter=k, nb_qp_iter=2 * k,
            problem_solved=True))
        dbg.duration_ocp_solve_ns = 1_000_000 + k
        rec.record(10_000 + k * 10, rng.normal(size=14), res, dbg)
    return rec


def _same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_recorder_npz_reads_across_packages(tmp_path, writer):
    reader = "port" if writer == "jax" else "jax"
    path = tmp_path / "run.npz"
    _record(writer).save(path)
    want = _record(reader).as_mpc_data()
    _same(PKGS[reader][0].load(path), want)
    _same(_record("port").as_mpc_data(), _record("jax").as_mpc_data())


@pytest.mark.parametrize("fmt", ["mcap", "sqlite3"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_recorder_bags_read_across_packages(tmp_path, writer, fmt):
    reader = "port" if writer == "jax" else "jax"
    path = tmp_path / f"run.{fmt}"
    _record(writer).save_bag(path, fmt=fmt)
    got = PKGS[reader][0].load_bag(path)
    want = PKGS[writer][0].load_bag(path)
    _same(got, want)
    npz = _record(reader).as_mpc_data()
    for k in ("x0", "state_predictions", "control_predictions", "iters",
              "solve_time_ns", "goal_residuals", "goal_references"):
        np.testing.assert_array_equal(got[k], npz[k], err_msg=k)
    np.testing.assert_allclose(got["time"], npz["time"])


def test_mcap_bags_are_byte_identical(tmp_path):
    for pkg in PKGS:
        _record(pkg).save_bag(tmp_path / f"{pkg}.mcap", fmt="mcap")
    assert (tmp_path / "port.mcap").read_bytes() == (
        tmp_path / "jax.mcap").read_bytes()


def test_recorder_roundtrip(tmp_path):
    """`test_runtime_plots.test_recorder_roundtrip` on the port."""
    rec = MPCRecorder()
    res = OCPResults(states=np.zeros((11, 3)),
                     ricatti_gains=np.zeros((10, 2, 3)),
                     feed_forward_terms=np.zeros((10, 2)))
    dbg = MPCDebugData(ocp=OCPDebugData(kkt_norm=1e-4, nb_iter=3),
                       duration_ocp_solve_ns=123456)
    for i in range(5):
        rec.record(i * 10**7, np.zeros(3), res, dbg)
    path = tmp_path / "run.npz"
    rec.save(path)
    data = MPCRecorder.load(path)
    assert data["state_predictions"].shape == (5, 11, 3)
    assert data["kkt"].shape == (5,)
    np.testing.assert_allclose(data["solve_time_ns"], 123456)


# -- bag containers (`test_observability_tail.py` on the port) ----------------
def _topics(rng):
    return {
        "/ocp_x0": [(1000 + i, rng.normal(size=14)) for i in range(5)],
        "/mpc_debug/state_predictions": [
            (1000 + i, rng.normal(size=(21, 14))) for i in range(5)],
    }


def _same_topics(back, topics):
    for name, recs in topics.items():
        assert len(back[name]) == len(recs)
        for (t0, a0), (t1, a1) in zip(recs, back[name]):
            assert t0 == t1
            np.testing.assert_array_equal(a0, a1)


@pytest.mark.parametrize("fmt", ["mcap", "sqlite3"])
def test_bag_roundtrip(tmp_path, fmt):
    rng = np.random.default_rng(0)
    topics = _topics(rng)
    path = tmp_path / f"run.{fmt}"
    write, read = ((br.write_mcap_bag, br.read_mcap_bag) if fmt == "mcap"
                   else (br.write_sqlite_bag, br.read_sqlite_bag))
    write(path, topics)
    _same_topics(read(path), topics)
    auto = br.load_bag(path)
    assert set(auto.keys()) == set(topics.keys())
    ts, x0 = br.load_mpc_inputs_from_bag(path)
    assert x0.shape == (5, 14) and ts[0] == 1000
    # the JAX reader reads the port's file
    _same_topics(jbr.load_bag(path), topics)


def _chunked(plain, compression, compress):
    """`plain`'s channel and message records moved into one Chunk record
    compressed by `compress` (the layout of real mcap writers)."""
    data = plain.read_bytes()
    off, end = 8, len(data) - 8
    inner, outer = b"", b""
    while off < end:
        op, length = struct.unpack_from("<BQ", data, off)
        rec = data[off:off + 9 + length]
        off += 9 + length
        if op in (br._OP_CHANNEL, br._OP_MESSAGE):
            inner += rec
        elif op == br._OP_DATA_END:
            body = compress(inner)
            name = compression.encode()
            chunk_body = (struct.pack("<QQQI", 0, 0, len(inner), 0)
                          + struct.pack("<I", len(name)) + name
                          + struct.pack("<Q", len(body)) + body)
            outer += br._rec(br._OP_CHUNK, chunk_body) + rec
        else:
            outer += rec
    return br._MCAP_MAGIC + outer + br._MCAP_MAGIC


@pytest.mark.parametrize("compression", ["", "zstd"])
def test_mcap_chunked_container(tmp_path, compression):
    """A chunked file parses, uncompressed and zstd-compressed, in both
    packages."""
    rng = np.random.default_rng(3)
    topics = _topics(rng)
    plain = tmp_path / "plain.mcap"
    br.write_mcap_bag(plain, topics)
    if compression == "zstd":
        zstd = pytest.importorskip("zstandard")
        compress = zstd.ZstdCompressor().compress
    else:
        compress = lambda b: b  # noqa: E731
    chunked = tmp_path / "chunked.mcap"
    chunked.write_bytes(_chunked(plain, compression, compress))
    _same_topics(br.read_mcap_bag(chunked), topics)
    _same_topics(jbr.read_mcap_bag(chunked), topics)


def test_mcap_lz4_chunk_without_lz4_raises(tmp_path):
    """The lz4 branch imports `lz4`, absent here: reading an lz4 chunk
    raises ImportError, as the JAX reader does."""
    try:
        import lz4  # noqa: F401
        pytest.fail("lz4 is installed: this case holds its absence")
    except ImportError:
        pass
    plain = tmp_path / "plain.mcap"
    br.write_mcap_bag(plain, _topics(np.random.default_rng(4)))
    chunked = tmp_path / "lz4.mcap"
    chunked.write_bytes(_chunked(plain, "lz4", lambda b: b))
    for read in (br.read_mcap_bag, jbr.read_mcap_bag):
        with pytest.raises(ImportError):
            read(chunked)


@pytest.mark.parametrize("fmt", ["mcap", "sqlite3"])
def test_recorder_bag_matches_npz(tmp_path, fmt):
    rec = _record("port")
    bag_path = tmp_path / f"run_bag.{fmt}"
    rec.save_bag(bag_path, fmt=fmt)
    npz = rec.as_mpc_data()
    back = MPCRecorder.load_bag(bag_path)
    np.testing.assert_allclose(back["time"], npz["time"])
    for k in ("x0", "state_predictions", "iters", "solve_time_ns"):
        np.testing.assert_array_equal(back[k], npz[k], err_msg=k)
    np.testing.assert_allclose(back["kkt"], npz["kkt"])
    with pytest.raises(ValueError):
        rec.save_bag(tmp_path / "x.bag", fmt="bag")


# -- checkpoints (`test_checkpoint.py` on the port, and across packages) ------
def make_mpc(T=10, pkg="port"):
    if pkg == "jax":
        from tests.test_mpc import UnicycleOCP, UnicycleWarmStart

        buffer = jbuffer.TrajectoryBuffer(jbuffer.DTFactorsNSeq(
            factors=[1], n_steps=[T]))
        mpc = JaxMPC()
        mpc.setup(UnicycleOCP(T), UnicycleWarmStart(), buffer)
        return mpc, buffer
    buffer = TrajectoryBuffer(DTFactorsNSeq(factors=[1], n_steps=[T]))
    mpc = MPC()
    mpc.setup(TorchUnicycleOCP(T), TorchUnicycleWarmStart(), buffer)
    return mpc, buffer


def test_checkpoint_roundtrip(tmp_path):
    T = 10
    mpc, buffer = make_mpc(T)
    for i in range(T + 3):
        mpc.append_trajectory_point(_port_point(i))
    sol = OCPResults(
        states=np.arange((T + 1) * 3, dtype=float).reshape(T + 1, 3),
        ricatti_gains=np.zeros((T, 2, 3)),
        feed_forward_terms=np.ones((T, 2)))
    mpc._warm_start.update_previous_solution(sol)
    path = tmp_path / "ckpt.npz"
    save_checkpoint(path, mpc)
    mpc2, buffer2 = make_mpc(T)
    assert load_checkpoint(path, mpc2)
    assert len(buffer2) == T + 3
    assert buffer2[0].point.id == 0
    np.testing.assert_allclose(buffer2[4].point.robot_configuration,
                               buffer[4].point.robot_configuration)
    prev = mpc2._warm_start._previous_solution
    np.testing.assert_allclose(prev.states, sol.states)
    np.testing.assert_allclose(prev.feed_forward_terms,
                               sol.feed_forward_terms)


def test_checkpoint_without_solution(tmp_path):
    mpc, _ = make_mpc(5)
    for i in range(7):
        mpc.append_trajectory_point(_port_point(i))
    path = tmp_path / "c.npz"
    save_checkpoint(path, mpc)
    mpc2, buf2 = make_mpc(5)
    assert not load_checkpoint(path, mpc2)  # no warm start stored
    assert len(buf2) == 7


def _full_points(pkg, n, seed=0):
    """Points with every field set (the JAX full-fidelity test's), in
    either package's types."""
    mod = jbuffer if pkg == "jax" else None
    P = mod.TrajectoryPoint if mod else TrajectoryPoint
    W = mod.TrajectoryPointWeights if mod else TrajectoryPointWeights
    WP = mod.WeightedTrajectoryPoint if mod else WeightedTrajectoryPoint
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        pt = P(id=i, time_ns=i * 10**7,
               robot_configuration=rng.normal(size=2),
               robot_velocity=rng.normal(size=1),
               robot_acceleration=rng.normal(size=1),
               robot_effort=rng.normal(size=2),
               forces={"tool": rng.normal(size=6)},
               end_effector_poses={"tool": (np.eye(3), rng.normal(size=3)),
                                   "elbow": (np.eye(3), rng.normal(size=3))},
               end_effector_velocities={"tool": rng.normal(size=6)})
        w = W(w_robot_configuration=rng.uniform(size=2),
              w_robot_velocity=rng.uniform(size=1),
              w_robot_acceleration=rng.uniform(size=1),
              w_robot_effort=rng.uniform(size=2),
              w_forces={"tool": rng.uniform(size=6)},
              w_end_effector_poses={"tool": rng.uniform(size=6)},
              w_end_effector_velocities={"tool": rng.uniform(size=6)},
              w_collision_avoidance=0.7 if i % 2 else None)
        out.append(WP(point=pt, weights=w))
    return out


def _same_value(va, vb, name):
    """Two field values equal: None, an array, a pose (R, p) or a dict of
    either."""
    if va is None or vb is None:
        assert va is None and vb is None, name
    elif isinstance(va, dict):
        assert set(va) == set(vb), name
        for k in va:
            _same_value(va[k], vb[k], f"{name}:{k}")
    elif isinstance(va, tuple):
        for x, y in zip(va, vb):
            np.testing.assert_array_equal(x, y, err_msg=name)
    else:
        np.testing.assert_array_equal(np.asarray(va), np.asarray(vb),
                                      err_msg=name)


def _same_points(a, b):
    """Every field of two weighted points equal."""
    for part in ("point", "weights"):
        pa, pb = getattr(a, part), getattr(b, part)
        for f, va in vars(pa).items():
            _same_value(va, getattr(pb, f), f)


def test_checkpoint_full_field_fidelity(tmp_path):
    T = 6
    mpc, buffer = make_mpc(T)
    for wp in _full_points("port", T + 4):
        mpc.append_trajectory_point(wp)
    path = tmp_path / "full.npz"
    save_checkpoint(path, mpc)
    mpc2, buffer2 = make_mpc(T)
    load_checkpoint(path, mpc2)
    assert len(buffer2) == len(buffer)
    for i in range(len(buffer)):
        _same_points(buffer2[i], buffer[i])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_reads_across_packages(tmp_path, writer):
    """A checkpoint of every field and a previous solution, written by one
    package, restores the same buffer and warm start in the other; the two
    writers' files hold the same arrays."""
    reader = "port" if writer == "jax" else "jax"
    T = 6
    load = load_checkpoint if writer == "jax" else jckpt.load_checkpoint
    rng = np.random.default_rng(2)
    sol = dict(states=rng.normal(size=(T + 1, 3)),
               ricatti_gains=rng.normal(size=(T, 2, 3)),
               feed_forward_terms=rng.normal(size=(T, 2)))
    files = {}
    for pkg in ("jax", "port"):
        mpc, _ = make_mpc(T, pkg)
        for wp in _full_points(pkg, T + 4):
            mpc.append_trajectory_point(wp)
        mpc._warm_start.update_previous_solution(
            (JaxResults if pkg == "jax" else OCPResults)(**sol))
        files[pkg] = tmp_path / f"{pkg}.npz"
        (jckpt.save_checkpoint if pkg == "jax" else save_checkpoint)(
            files[pkg], mpc)
    with np.load(files["jax"]) as a, np.load(files["port"]) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    mpc_r, buf_r = make_mpc(T, reader)
    assert load(files[writer], mpc_r)
    want = _full_points(reader, T + 4)
    assert len(buf_r) == len(want)
    for i in range(len(want)):
        _same_points(buf_r[i], want[i])
    prev = mpc_r._warm_start._previous_solution
    for f, v in sol.items():
        np.testing.assert_array_equal(getattr(prev, f), v)


def test_checkpoint_resume_matches_uninterrupted_run(tmp_path):
    """Restore mid-run into a fresh pipeline and match the next controls of
    an uninterrupted run (the ring-fed "sqp" `OCPTorch` on the 2-DoF arm,
    f64, 1e-10)."""
    from agimus_controller_tpu_torch.models.urdf import build_model_from_urdf
    from agimus_controller_tpu_torch.mpc.ocp_base import OCPParams, OCPTorch
    from agimus_controller_tpu_torch.mpc.ring import (
        PackedTrajectoryBuffer,
        RowLayout,
    )
    from agimus_controller_tpu_torch.mpc.warm_start import (
        WarmStartReference,
        WarmStartShiftPreviousSolution,
    )
    from agimus_controller_tpu_torch.ops import dynamics, kinematics
    from tests.test_ring_control_loop import Q0, T as T_RING, URDF_2DOF
    from tests.test_torch_ocp_base import DT_EXACT, _params, _point, _specs

    model, params = build_model_from_urdf(
        URDF_2DOF, armature=np.array([0.1, 0.1]), dtype=torch.float64,
        device="cpu")
    q0 = torch.as_tensor(Q0)
    R0, p0 = (a.numpy() for a in kinematics.frame_placement(
        model, params, q0, model.frame_id("tip")))
    tau_g = dynamics.rnea(model, params, q0, torch.zeros(2, dtype=q0.dtype),
                          torch.zeros(2, dtype=q0.dtype)).numpy()
    arm = dict(R0=R0, p0=p0, tau_g=tau_g)
    _, spec = _specs("goal", DT_EXACT)

    def build():
        buf = PackedTrajectoryBuffer(
            DTFactorsNSeq(factors=[1], n_steps=[T_RING]),
            RowLayout(spec, model), dtype=torch.float64, device="cpu")
        ocp = OCPTorch(model, params, spec, _params(OCPParams, "sqp",
                                                    DT_EXACT),
                       dtype=torch.float64, ring=buf.ring, device="cpu")
        ws = WarmStartShiftPreviousSolution()
        ws.setup(model, params, spec.timesteps(), device="cpu")
        m = MPC()
        m.setup(ocp, ws, buf)
        return m, buf

    def x0pt(k):
        return TrajectoryPoint(time_ns=int(k * DT_EXACT * 1e9),
                               robot_configuration=Q0.copy(),
                               robot_velocity=np.zeros(2))

    def first_solve(m, buf):
        ws_ref = WarmStartReference()
        ws_ref.setup(model, params, device="cpu")
        horizon = buf.horizon
        m._ocp.set_reference_weighted_trajectory(horizon)
        x0, xs, us = ws_ref.generate(x0pt(0), [wp.point for wp in horizon])
        m._warm_start.update_previous_solution(m._ocp.solve(
            x0, xs, us, use_iteration_limits_and_timeout=False))

    n_fill, n_ticks = 3 * T_RING, 6

    def prefix():
        m, buf = build()
        for i in range(n_fill):
            m.append_trajectory_point(_point(i, arm, DT_EXACT))
        first_solve(m, buf)
        m.run(x0pt(0), 0)
        return m

    def ticks(m):
        us = []
        for k in range(n_ticks):
            m.append_trajectory_point(_point(n_fill + k, arm, DT_EXACT))
            us.append(m.run(x0pt(k + 1), k + 1).feed_forward_terms[0].copy())
        return np.asarray(us)

    us_a = ticks(prefix())
    path = tmp_path / "mid.npz"
    save_checkpoint(path, prefix())
    m_c, _ = build()
    assert load_checkpoint(path, m_c)
    np.testing.assert_allclose(ticks(m_c), us_a, rtol=0, atol=1e-10)
