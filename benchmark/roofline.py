"""The yardstick of the kernel rooflines: the card's published peaks, the
work kinds' byte formulas (`work/<kind>.json`), their frozen operation
counts per robot and cost model (`work/ops/<name>.json`, named by a
configuration's "work_ops") and the kernel names
mapped to work kinds (`kernels/<name>.json`).

The least time of a launch over N nodes is max(bytes / peak bandwidth,
operations / peak fp32 rate): every input float of a node read once, every
output float written once, the packed constants read once per launch.
"""

from __future__ import annotations

import ast
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


def size_expr(expr: str, sizes: dict) -> int:
    """The value of a formula of sizes ("nx + W + nj + 1", "T*B"): names,
    integers, + and * only."""
    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.Add,
                                                                ast.Mult)):
            a, b = ev(node.left), ev(node.right)
            return a + b if isinstance(node.op, ast.Add) else a * b
        if isinstance(node, ast.Name):
            return int(sizes[node.id])
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            return node.value
        raise ValueError(f"not a size formula: {expr!r}")
    return ev(ast.parse(expr, mode="eval"))


def _load(path: Path):
    return json.loads(path.read_text())


def kernel_map(root: Path = HERE) -> dict:
    """{kernel name: its mapping} of every file under `kernels/`."""
    return {p.stem: _load(p) for p in sorted((root / "kernels").glob("*.json"))}


def kernel_name(trace_name: str) -> str:
    """A device event's kernel name without its return type, namespace,
    template arguments and parameters: "void ag::k<7>(int, ...)" -> "k"."""
    name = trace_name.replace("(anonymous namespace)::", "")
    head = name.split("(", 1)[0].split("<", 1)[0].strip()
    return head.split()[-1].split("::")[-1] if head else trace_name


def bound_s(work: str, ops: str, nodes: int, nj: int,
            root: Path = HERE) -> tuple:
    """(least seconds, "bytes" or "operations") of one launch of `work`
    over `nodes` nodes, with the counts of `work/ops/<ops>.json` (joint
    count nj)."""
    form = _load(root / "work" / f"{work}.json")
    counts = _load(root / "work" / "ops" / f"{ops}.json")[work]
    sizes = dict(nj=nj, nx=2 * nj, W=counts.get("W", 0))
    per_node = (size_expr(form["floats_in_per_node"], sizes)
                + size_expr(form["floats_out_per_node"], sizes))
    n_bytes = form["bytes_per_float"] * (nodes * per_node + counts["consts"])
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = nodes * counts["ops_per_node"] / PEAK_FP32_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
