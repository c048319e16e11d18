"""YAML OCP DSL build/update round-trip demo on the PyTorch port (the
port's copy of `examples/ocp_dsl_roundtrip.py`; reference
`agimus_controller_examples/scripts/ocp_generic_tests.py`): parse a problem
definition into the static spec, show the parsed tree, mutate a weight the
functional way (`dataclasses.replace` — the analog of the reference's
`update()` object mutation), and evaluate one stage cost before and after
to demonstrate that references/weights are runtime inputs.

Without a file it takes the shipped goal-reaching definition as the port
holds it parsed (`ocp/definitions.py`, no PyYAML needed).

Usage:  python examples/ocp_dsl_roundtrip_torch.py [definition.yaml]
            [--device cuda|cpu]
"""

import argparse
import dataclasses

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("yaml_file", nargs="?", default=None)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    import torch

    from agimus_controller_tpu_torch.models.panda import (
        PANDA_Q_READY,
        load_panda,
    )
    from agimus_controller_tpu_torch.ocp import definitions
    from agimus_controller_tpu_torch.ocp.costs import build_cost_functions
    from agimus_controller_tpu_torch.ocp.spec import default_references
    from agimus_controller_tpu_torch.ocp.yaml_compiler import load_ocp_spec

    source = args.yaml_file or definitions.GOAL_REACHING
    label = args.yaml_file or "ocp_goal_reaching.yaml (parsed copy)"
    device = torch.device(args.device)
    model, params = load_panda(device=device)
    T = 10
    spec = load_ocp_spec(source, model, horizon=T, dt=0.01,
                         default_ee_frame="panda_hand_tcp")

    print(f"parsed {label}:")
    for group, items in (("running", spec.running_costs),
                         ("terminal", spec.terminal_costs)):
        for c in items:
            print(f"  [{group}] {c.name}: kind={c.kind} weight={c.weight} "
                  f"update={c.update} activation={c.activation}")
    for c in spec.constraints:
        print(f"  [constraint] {c.name}: kind={c.kind} "
              f"lower={c.lower} upper={c.upper}")

    # round trip: spec -> dict -> spec (the as_dict demo of the reference)
    as_dict = dataclasses.asdict(spec)
    print(f"\nas_dict round-trip keys: {sorted(as_dict)[:4]} ...")

    # evaluate a stage cost, then "update" a weight — functionally: the
    # static weight via dataclasses.replace, or (the hot path) the runtime
    # weight arrays in refs, with no rebuild
    f32 = dict(dtype=torch.float32, device=device)
    cf = build_cost_functions(model, params, spec, dtype=torch.float32)
    refs = default_references(spec, model, dtype=torch.float32, device=device)
    x = torch.cat([torch.as_tensor(np.asarray(PANDA_Q_READY), **f32),
                   torch.zeros(7, **f32)])
    u = torch.zeros(7, **f32)
    c0 = float(cf.stage_cost(x, u, 0, refs))

    refs2 = dict(refs)
    if "w_x" in refs2:
        refs2["w_x"] = 10.0 * refs2["w_x"]
    c1 = float(cf.stage_cost(x, u, 0, refs2))
    print(f"\nstage cost @node0: {c0:.6f} -> {c1:.6f} after scaling the "
          "streamed state weights x10 (runtime refs update, no rebuild)")

    target = next((c.name for c in spec.running_costs
                   if c.kind != "control"), spec.running_costs[0].name)
    running2 = tuple(
        dataclasses.replace(c, weight=c.weight * 2.0)
        if c.name == target else c for c in spec.running_costs)
    spec2 = dataclasses.replace(spec, running_costs=running2)
    cf2 = build_cost_functions(model, params, spec2, dtype=torch.float32)
    c2 = float(cf2.stage_cost(x, u, 0, refs))
    print(f"static-weight rebuild ({target} x2): {c0:.6f} -> {c2:.6f}")
    assert abs(c1 - c0) > 0 or abs(c2 - c0) > 0
    print("\nround trip OK")


if __name__ == "__main__":
    main()
