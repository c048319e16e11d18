"""Compare the compiled device code (SASS) of two checkouts' kernels.

    python3 examples/kernel_sass_diff.py PARENT_DIR CHANGE_DIR [OLD=NEW ...]
        [--show N]

Builds the kernel libraries of each checkout (`ops/_build.py` of that
checkout, into its own build directory: the libraries of the joint counts
2, 7 and 8 where a checkout builds one per count, else its one library),
disassembles both with
`cuobjdump -sass` and prints, per kernel instance, the instruction counts
and whether the two are the same instruction for instruction (addresses,
encodings and the compilation unit's anonymous-namespace hash removed);
OLD=NEW pairs a kernel renamed between the two, e.g.
`terminal_kernel<7,0>=terminal_k4_kernel<7>`; --show N prints the first N
differing lines of each kernel that differs.
Needs the CUDA toolkit (`nvcc`, `cuobjdump` under /usr/local/cuda); no
GPU. A kernel whose source did not change but whose SASS did was
compiled differently (inlining, scheduling), which the register and
stack-frame figures of ptxas do not show.
"""

from __future__ import annotations

import difflib
import re
import subprocess
import sys
from pathlib import Path

CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"


NJS = (2, 7, 8)  # the joint counts compared


def build(root: Path) -> list[str]:
    """Paths of root's kernel libraries, built if missing."""
    code = (f"import sys; sys.path.insert(0, {str(root)!r}); "
            "from agimus_controller_tpu_torch.ops import _build; "
            "paths = ([p for p, _ in _build.build_many("
            f"{NJS!r})] if hasattr(_build, 'build_many') "
            "else [_build.build()[0]]); "
            "print('|'.join(str(p) for p in paths))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[-1].split("|")


def kernel_name(mangled: str) -> str:
    """`step_derivs_kernel<7>` (or `<7,0>` with a bool argument) from the
    mangled symbol."""
    for m in re.finditer(r"\d+", mangled):
        for k in range(len(m.group())):  # the length prefix ends the run
            name = mangled[m.end():m.end() + int(m.group()[k:])]
            args = re.match(r"ILi(\d+)E(?:Lb([01])E)?",
                            mangled[m.end() + len(name):])
            if name.endswith("_kernel") and args:
                return f"{name}<{','.join(a for a in args.groups() if a)}>"
    return mangled


def sass(libs: list[str]) -> dict[str, list[str]]:
    """Instructions of every kernel in libs, by kernel name."""
    text = "\n".join(subprocess.run([CUOBJDUMP, "-sass", lib],
                                    capture_output=True, text=True,
                                    check=True).stdout for lib in libs)
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(kernel_name(m.group(1)), [])
            continue
        if "Fatbin" in line:  # the next embedded binary's header
            cur = None
        if cur is None:
            continue
        ins = re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/", "", line)
        ins = re.sub(r"_GLOBAL__N__\w+?_cu_\w*?(?=\d)", "", ins).strip()
        if ins:
            cur.append(ins)
    return funcs


def main():
    args, show = sys.argv[1:], 0
    if "--show" in args:
        i = args.index("--show")
        show = int(args[i + 1])
        del args[i:i + 2]
    if len(args) < 2:
        raise SystemExit(__doc__)
    a, b = (sass(build(Path(r).resolve())) for r in args[:2])
    for pair in args[2:]:
        old, new = pair.split("=")
        a[new] = a.pop(old)
    for name in sorted(set(a) | set(b)):
        if name not in a or name not in b:
            side = "first" if name in a else "second"
            print(f"{name}: only in the {side} checkout")
            continue
        if a[name] == b[name]:
            print(f"{name}: {len(a[name])} instructions, identical")
            continue
        lines = [l for l in difflib.unified_diff(a[name], b[name], n=0,
                                                  lineterm="")
                 if l[:1] in "+-" and not l.startswith(("+++", "---"))]
        print(f"{name}: {len(a[name])} -> {len(b[name])} instructions, "
              f"{len(lines)} lines differ")
        for line in lines[:show]:
            print("   ", line)


if __name__ == "__main__":
    main()
