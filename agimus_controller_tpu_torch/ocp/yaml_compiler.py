"""YAML OCP DSL compiler: reference problem-definition files -> ProblemSpec.

Port of the JAX package's `ocp/yaml_compiler.py`: the same `class:`-tagged
schema the reference deserializes into its OCP dataclasses
(`ocp/ocp_croco_generic.py:41-53,764-790`; shipped definitions
`ocp_goal_reaching.yaml`, `ocp_traj_tracking_collision_avoidance.yaml`)
compiles to a static `ProblemSpec`.

PyYAML is imported only to parse text or a file; an already-parsed dict
needs nothing beyond this package. The soft-contact (force-feedback) schema
is not ported yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple, Union

from ..models.model import RobotModel
from .spec import ConstraintItem, CostItem, ProblemSpec

_RESIDUAL_KINDS = {
    "ResidualModelState": "state",
    "ResidualModelControl": "control",
    "ResidualModelControlGrav": "control_grav",
    "ResidualModelFramePlacement": "frame_placement",
    "ResidualModelFrameTranslation": "frame_translation",
    "ResidualModelFrameRotation": "frame_rotation",
    "ResidualModelFrameVelocity": "frame_velocity",
    "ResidualModelVisualServoing": "visual_servoing",
    "ResidualDistanceCollision": "collision_distance",
    "ResidualDistanceCollision2": "collision_distance",
}


def _parse_activation(node: Optional[dict]) -> Tuple[str, float, Optional[tuple]]:
    """-> (activation, alpha, static weights)."""
    if node is None:
        return "weighted_quad", 1.0, None
    cls = node.get("class")
    if cls == "ActivationModelWeightedQuad":
        w = node.get("weights")
        if w is None:
            return "weighted_quad", 1.0, None
        if isinstance(w, (int, float)):
            return "weighted_quad", 1.0, (float(w),)
        return "weighted_quad", 1.0, tuple(float(x) for x in w)
    if cls == "ActivationModelExp":
        kind = "exp" if int(node.get("exponent", 1)) == 1 else "quad_exp"
        return kind, float(node.get("alpha", 1.0)), None
    if cls == "ActivationModelQuadExp":
        return "quad_exp", float(node.get("alpha", 1.0)), None
    raise ValueError(f"unknown activation class {cls!r}")


def _frame_name(res_node: dict, model: RobotModel,
                default_ee_frame: Optional[str]):
    """The residual's frame: a static `frame_id:` string names it; the
    reference's dynamic-id residuals (`id:` int, rebound per tick to the
    single end-effector key, `ocp_croco_generic.py:198-221`) bind to
    ``default_ee_frame``."""
    fid = res_node.get("frame_id", res_node.get("id"))
    if isinstance(fid, str):
        model.frame_id(fid)  # validate
        return fid
    if default_ee_frame is None:
        raise ValueError(
            "residual uses a dynamic frame id; pass default_ee_frame to bind it")
    model.frame_id(default_ee_frame)
    return default_ee_frame


def _parse_cost(entry: dict, model: RobotModel, default_ee_frame) -> CostItem:
    cost_node = entry.get("cost", {})
    if cost_node.get("class") not in (None, "CostModelResidual"):
        raise ValueError(f"unsupported cost class {cost_node.get('class')!r}")
    res = cost_node.get("residual", {})
    cls = res.get("class")
    if cls not in _RESIDUAL_KINDS:
        raise ValueError(f"unknown residual class {cls!r}")
    kind = _RESIDUAL_KINDS[cls]
    activation, alpha, act_w = _parse_activation(cost_node.get("activation"))
    kwargs = dict(
        name=entry["name"], kind=kind, weight=float(entry.get("weight", 1.0)),
        update=bool(entry.get("update", False)), activation=activation,
        act_alpha=alpha, act_weights=act_w,
        active=bool(entry.get("active", True)),
        publish_residual=bool(entry.get("publish_residual", False)))
    if kind in ("frame_placement", "frame_translation", "frame_rotation",
                "frame_velocity"):
        kwargs["frame"] = _frame_name(res, model, default_ee_frame)
        if kind == "frame_velocity":
            kwargs["reference_frame"] = res.get("reference_frame", "WORLD").lower()
    elif kind == "visual_servoing":
        kwargs["frame"] = res["robot_frame"]
        model.frame_id(kwargs["frame"])
        kwargs["object_frame"] = res["object_frame"]
    elif kind == "collision_distance":
        kwargs["pair_id"] = int(res.get("collision_pair_id", 0))
        if kwargs["pair_id"] >= len(model.collision_pairs):
            raise ValueError(
                f"collision_pair_id {kwargs['pair_id']} out of range "
                f"({len(model.collision_pairs)} pairs registered)")
    for key in ("pref", "xref", "uref"):
        if res.get(key) is not None:
            kwargs["static_ref"] = tuple(float(v) for v in res[key])
    return CostItem(**kwargs)


def _parse_constraint(entry: dict, model: RobotModel,
                      default_ee_frame) -> ConstraintItem:
    node = entry["constraint"]
    cls = node.get("class")
    if cls == "ConstraintModelControlLimit":
        return ConstraintItem(name=entry["name"], kind="control_limit")
    if cls != "ConstraintModelResidual":
        raise ValueError(f"unknown constraint class {cls!r}")
    res = node.get("residual", {})
    kind = _RESIDUAL_KINDS.get(res.get("class"))
    if kind is None:
        raise ValueError(f"unknown constraint residual class {res.get('class')!r}")
    kwargs = dict(name=entry["name"], kind=kind, terminal=bool(node.get(
        "active_on_terminal_node", node.get("terminal", True))))  # ref default
    if kind.startswith("frame_"):
        kwargs["frame"] = _frame_name(res, model, default_ee_frame)
    if kind == "collision_distance":
        kwargs["pair_id"] = int(res.get("collision_pair_id", 0))

    def _bound(key):
        v = node.get(key)
        if v is None:
            return ()
        if isinstance(v, (int, float, str)):
            return (float(v),)
        return tuple(float(x) for x in v)

    kwargs["lower"] = _bound("lower")
    kwargs["upper"] = _bound("upper")
    return ConstraintItem(**kwargs)


def _read_tree(source: Union[str, Path, dict]) -> dict:
    if isinstance(source, dict):
        return source
    import yaml  # only text and files need the parser

    is_file = isinstance(source, Path) or (
        "\n" not in str(source) and Path(str(source)).is_file())
    text = Path(source).read_text() if is_file else str(source)
    return yaml.safe_load(text)


def load_ocp_spec(
    source: Union[str, Path, dict],
    model: RobotModel,
    horizon: int,
    dt: float,
    dt_factor_n_seq: Tuple[Tuple[int, int], ...] = (),
    default_ee_frame: Optional[str] = None,
) -> ProblemSpec:
    """Compile a reference-format OCP YAML into a ProblemSpec.

    ``source``: YAML text, a path to a YAML file, or an already-parsed dict.
    """
    tree = _read_tree(source)

    def model_costs(node):
        diff = node.get("differential", {})
        costs = tuple(_parse_cost(e, model, default_ee_frame)
                      for e in diff.get("costs", []))
        cons = tuple(_parse_constraint(e, model, default_ee_frame)
                     for e in diff.get("constraints", []))
        return costs, cons

    if tree["running_model"].get("differential", {}).get("class") == \
            "DAMSoftContactAugmentedFwdDynamics":
        raise NotImplementedError(
            "soft contact is not ported yet (ROADMAP queue 1, slice 12)")
    running, r_cons = model_costs(tree["running_model"])
    terminal, t_cons = model_costs(tree.get("terminal_model",
                                            {"differential": {}}))
    # terminal-model constraint entries are flagged terminal
    t_cons = tuple(ConstraintItem(**{**c.__dict__, "terminal": True})
                   for c in t_cons)
    # terminal models carry no control: control costs are dropped, like the
    # reference's terminal DAM
    terminal = tuple(c for c in terminal
                     if c.kind not in ("control", "control_grav"))
    return ProblemSpec(
        running_costs=running, terminal_costs=terminal,
        constraints=tuple(dict.fromkeys(r_cons + t_cons)), horizon=horizon,
        dt=dt, dt_factor_n_seq=tuple(dt_factor_n_seq))
