"""The two shipped OCP definitions as parsed trees.

The JAX package ships them as YAML files
(`agimus_controller_tpu/ocp/definitions/ocp_goal_reaching.yaml` and
`ocp_traj_tracking_collision_avoidance.yaml`, the DSL of the reference's
`agimus_controller/ocp/*.yaml`). Here each is the tree `yaml.safe_load`
gives for its file, so "1e-4" and "inf" stay strings, as there; the
compiler (`yaml_compiler.load_ocp_spec`) takes a tree without PyYAML.
"""

from __future__ import annotations

_QUAD = {"class": "ActivationModelWeightedQuad", "weights": 1.0}
_DAM = "DifferentialActionModelFreeFwdDynamics"


def _cost(name, residual, activation=None, update=True):
    return {"name": name, "update": update, "weight": 1.0,
            "cost": {"class": "CostModelResidual",
                     "activation": dict(activation or _QUAD),
                     "residual": residual}}


def _model(costs, constraints=None):
    differential = {"class": _DAM, "costs": costs}
    if constraints is not None:
        differential["constraints"] = constraints
    return {"class": "IntegratedActionModelEuler", "differential": differential}


def _control_reg():
    return _cost("control_reg", {"class": "ResidualModelControl"})


def _state_reg():
    return _cost("state_reg", {"class": "ResidualModelState"})


def _goal_tracking():
    return _cost("goal_tracking",
                 {"class": "ResidualModelFramePlacement", "id": 0})


def _distance():
    return _cost("distance", {"class": "ResidualDistanceCollision",
                              "collision_pair_id": 0},
                 {"class": "ActivationModelQuadExp", "alpha": "1e-4"},
                 update=False)


# `ocp_goal_reaching.yaml`: control/state regularization + frame-placement
# goal tracking, all reference-updated per tick
GOAL_REACHING = {
    "running_model": _model([_control_reg(), _state_reg(), _goal_tracking()]),
    "terminal_model": _model([_state_reg(), _goal_tracking()]),
}

# `ocp_traj_tracking_collision_avoidance.yaml`: regularization + goal
# tracking + QuadExp collision-distance cost + hard lower-bound distance
# constraint
TRAJ_TRACKING_COLLISION_AVOIDANCE = {
    "running_model": _model(
        [_control_reg(), _state_reg(), _goal_tracking(), _distance()],
        [{"name": "collision", "constraint": {
            "class": "ConstraintModelResidual", "lower": 0.01,
            "upper": "inf", "residual": {
                "class": "ResidualDistanceCollision",
                "collision_pair_id": 0}}}]),
    "terminal_model": _model([_state_reg(), _goal_tracking(), _distance()]),
}
