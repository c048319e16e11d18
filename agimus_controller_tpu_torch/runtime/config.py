"""Engine configuration loader, schema-compatible with the reference's node
parameters (`agimus_controller_ros/agimus_controller_parameters.yaml:1-114`,
compiled there by generate_parameter_library; here a typed dataclass loader).

Accepts either the generate_parameter_library *schema* layout (leaves are
``{type, default_value, ...}`` dicts) or a plain ROS-style values file (leaves
are values), under the ``agimus_controller_params`` root key or flat.

Port of the JAX package's `runtime/config.py`: PyYAML is imported only to
parse text or a file; a dict needs none.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Tuple, Union

import numpy as np

from ..mpc.ocp_base import OCPParams
from .controller import RuntimeParams


@dataclasses.dataclass
class EngineConfig:
    """Full engine configuration (reference node params, SURVEY.md §5)."""

    ocp: OCPParams
    runtime: RuntimeParams
    armature: np.ndarray
    definition_yaml_file: str = ""
    robot_attachment_frame: str = "robot_attachment_link"
    free_flyer: bool = False
    collision_as_capsule: bool = True
    self_collision: bool = True
    collision_pairs: List[Tuple[str, str]] = dataclasses.field(default_factory=list)
    moving_geometries_names: List[str] = dataclasses.field(default_factory=list)
    publish_debug_data: bool = True
    publish_buffer_size: bool = False
    activate_callback: bool = False
    n_threads: int = 1


def _leaf(node, default=None):
    """Support both schema nodes ({type, default_value}) and raw values."""
    if isinstance(node, dict) and "default_value" in node:
        return node["default_value"]
    if isinstance(node, dict) and "type" in node and "default_value" not in node:
        return default
    return node if node is not None else default


def load_engine_config(source: Union[str, Path, dict]) -> EngineConfig:
    if isinstance(source, dict):
        tree = source
    else:
        is_path = isinstance(source, Path) or (
            "\n" not in str(source) and Path(str(source)).is_file()
        )
        text = Path(source).read_text() if is_path else str(source)
        import yaml  # only text and files need the parser

        tree = yaml.safe_load(text)
    # unwrap the node-name root and the ros __params__ layer when present
    for key in ("agimus_controller_params", "agimus_controller", "ros__parameters"):
        if isinstance(tree, dict) and key in tree:
            tree = tree[key]
    ocp_t = tree.get("ocp", {})
    dtf = ocp_t.get("dt_factor_n_seq", {})
    factors = [int(v) for v in _leaf(dtf.get("factors"), [1])]
    n_steps = [int(v) for v in _leaf(dtf.get("n_steps"), [19])]
    if any(f <= 0 for f in factors) or any(n <= 0 for n in n_steps):
        raise ValueError("dt_factor_n_seq entries must be > 0")
    horizon = int(_leaf(ocp_t.get("horizon_size"), sum(n_steps)))
    if horizon != sum(n_steps):
        raise ValueError(
            f"horizon_size {horizon} != sum(n_steps) {sum(n_steps)} "
            "(reference asserts the same, ocp_param_base.py:79)"
        )
    n_threads = int(_leaf(ocp_t.get("n_threads"), 1))
    if n_threads <= 0:
        raise ValueError("n_threads must be > 0")
    # solver backend knob (not in the reference's schema — its runtime
    # solver is fixed to mim_solvers CSQP, `ocp_base_croco.py:64-80`; here
    # "auto" resolves to the batch-native latency SQP, VERDICT r04 #2)
    solver = str(_leaf(ocp_t.get("solver"), "auto"))
    if solver not in ("auto", "sqp", "csqp", "fddp"):
        raise ValueError(
            f"ocp.solver must be one of auto/sqp/csqp/fddp, got {solver!r}")
    ocp = OCPParams(
        dt=float(_leaf(ocp_t.get("dt"), 0.01)),
        horizon_size=horizon,
        dt_factor_n_seq=tuple(zip(factors, n_steps)),
        solver_iters=int(_leaf(ocp_t.get("max_iter"), 10)),
        qp_iters=int(_leaf(ocp_t.get("max_qp_iter"), 100)),
        termination_tolerance=float(_leaf(ocp_t.get("termination_tolerance"), 1e-3)),
        max_solve_time=float(_leaf(ocp_t.get("max_solve_time"), 0.1)),
        n_threads=n_threads,
        solver=solver,
    )
    runtime = RuntimeParams(
        rate=float(_leaf(tree.get("rate"), 100.0)),
        constant_delay=bool(_leaf(tree.get("constant_delay"), False)),
        publish_debug_data=bool(_leaf(tree.get("publish_debug_data"), True)),
    )
    pair_names = [p for p in _leaf(tree.get("collision_pairs_names"), []) if p]
    pairs = []
    for name in pair_names:
        entry = tree.get(name, {})
        first = _leaf(entry.get("first"))
        second = _leaf(entry.get("second"))
        if first and second:
            pairs.append((first, second))
    return EngineConfig(
        ocp=ocp,
        runtime=runtime,
        armature=np.asarray(_leaf(ocp_t.get("armature"), [0.1] * 7), dtype=float),
        definition_yaml_file=str(_leaf(ocp_t.get("definition_yaml_file"), "")),
        robot_attachment_frame=str(
            _leaf(tree.get("robot_attachment_frame"), "robot_attachment_link")),
        free_flyer=bool(_leaf(tree.get("free_flyer"), False)),
        collision_as_capsule=bool(_leaf(tree.get("collision_as_capsule"), True)),
        self_collision=bool(_leaf(tree.get("self_collision"), True)),
        collision_pairs=pairs,
        moving_geometries_names=[
            g for g in _leaf(tree.get("moving_geometries_names"), []) if g
        ],
        publish_debug_data=runtime.publish_debug_data,
        publish_buffer_size=bool(_leaf(tree.get("publish_buffer_size"), False)),
        activate_callback=bool(_leaf(tree.get("activate_callback"), False)),
        n_threads=n_threads,
    )
