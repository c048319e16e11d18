"""Minimal xacro expansion: the subset the reference's model files use.

Port of the JAX package's `models/xacro.py` (standard library only, the
same code). The reference rebuilds robot/environment models from xacro at
runtime (`agimus_controller_ros/mpc_plot_node.py:34-97`,
`agimus_controller_examples/.../set_models_and_mpc.py:18-44`, test env
`agimus_controller/tests/resources/environment.xacro`). xacro itself is a
ROS tool; this module expands the subset those files exercise so a
reference-shipped ``.xacro`` drops straight into
`build_model_from_urdf(env_urdf=...)`:

- ``<xacro:property name= value=/>`` + ``${expr}`` substitution (safe
  arithmetic over properties, ``pi`` and ``math`` functions);
- ``<xacro:macro name= params=>`` definition and ``<xacro:NAME .../>``
  invocation with attribute parameters and defaults
  (``params="a b:=1.0"``);
- ``<xacro:include filename=/>`` with ``$(find pkg)`` resolved through a
  caller-supplied ``packages`` mapping; unresolvable includes fall back
  to the BUILTIN macro library below (warn) instead of failing, because
  the reference's includes pull macros from robot-description packages
  (franka_description utils) that are not installed beside this package;
- builtin ``collision_capsule`` macro (the one external macro the
  reference's environment files call): emits a named cylinder collision
  the URDF compiler's ``collision_as_capsule=True`` path converts to a
  capsule, with the axis rotated per ``direction`` (x/y/z).

Non-strict expansion drops an unknown macro with only a warning, as the JAX
package does (ROADMAP queue 3, known reference behaviour).
"""

from __future__ import annotations

import logging
import math
import re
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, Optional

logger = logging.getLogger(__name__)

_XACRO_NS = "http://www.ros.org/wiki/xacro"
_SAFE_NAMES = {
    "pi": math.pi, "sin": math.sin, "cos": math.cos, "tan": math.tan,
    "sqrt": math.sqrt, "atan2": math.atan2, "abs": abs, "min": min,
    "max": max, "radians": math.radians, "degrees": math.degrees,
}

# direction -> rpy rotating the cylinder's +z axis onto that direction
_DIR_RPY = {"x": "0 1.5707963267948966 0",
            "y": "-1.5707963267948966 0 0",
            "z": "0 0 0"}


def _builtin_collision_capsule() -> ET.Element:
    """franka_description `collision_capsule` semantics: a named cylinder
    collision (our URDF compiler capsule-izes cylinders); the macro body
    uses the xacro param substitution below."""
    xml = """<xacro:macro xmlns:xacro="{ns}" name="collision_capsule"
        params="xyz:='0 0 0' direction:=z radius length name:=capsule">
      <collision name="${{name}}">
        <origin xyz="${{xyz}}" rpy="${{_dir_rpy}}"/>
        <geometry><cylinder radius="${{radius}}" length="${{length}}"/></geometry>
      </collision>
    </xacro:macro>""".format(ns=_XACRO_NS)
    return ET.fromstring(xml)


def _tag(el: ET.Element) -> str:
    if el.tag.startswith("{%s}" % _XACRO_NS):
        return el.tag[len(_XACRO_NS) + 2:]
    return ""


def _subst(text: str, props: Dict[str, object]) -> str:
    """Expand every ${...} in ``text`` against ``props``."""
    if text is None or "${" not in text:
        return text

    def repl(m):
        expr = m.group(1)
        env = dict(_SAFE_NAMES)
        env.update(props)
        try:
            val = eval(expr, {"__builtins__": {}}, env)  # noqa: S307
        except Exception:
            # bare property lookup (names with slashes etc.)
            if expr in props:
                val = props[expr]
            else:
                raise KeyError(
                    f"xacro: cannot evaluate ${{{expr}}} "
                    f"(known properties: {sorted(props)})") from None
        if isinstance(val, float) and val == int(val) and abs(val) < 1e15:
            # xacro prints integral floats without the trailing .0 only
            # in expressions; keep float repr for URDF friendliness
            return repr(val)
        return str(val)

    return re.sub(r"\$\{([^}]*)\}", repl, text)


def _coerce(s: str):
    try:
        f = float(s)
        return f
    except (TypeError, ValueError):
        return s


class _Expander:
    def __init__(self, packages: Optional[Dict[str, str]] = None,
                 base_dir: Optional[Path] = None, strict: bool = False):
        self.packages = dict(packages or {})
        self.base_dir = base_dir
        self.strict = strict
        self.props: Dict[str, object] = {}
        self.macros: Dict[str, ET.Element] = {
            "collision_capsule": _builtin_collision_capsule()}

    # -- includes -------------------------------------------------------
    def _resolve(self, filename: str) -> Optional[Path]:
        m = re.match(r"\$\(find ([^)]+)\)(.*)", filename)
        if m:
            pkg, rest = m.group(1), m.group(2).lstrip("/")
            root = self.packages.get(pkg)
            if root is None:
                return None
            return Path(root) / rest
        p = Path(filename)
        if not p.is_absolute() and self.base_dir is not None:
            p = self.base_dir / p
        return p if p.is_file() else None

    def _include(self, el: ET.Element):
        filename = _subst(el.get("filename", ""), self.props)
        path = self._resolve(filename)
        if path is None or not path.is_file():
            msg = (f"xacro include {filename!r} not resolvable; relying on "
                   "builtin macros (pass packages={'pkg': path} to resolve)")
            if self.strict:
                raise FileNotFoundError(msg)
            logger.warning(msg)
            return
        sub = ET.fromstring(path.read_text())
        self._collect_defs(sub)

    def _collect_defs(self, root: ET.Element):
        for el in list(root):
            t = _tag(el)
            if t == "include":
                self._include(el)
            elif t == "property":
                self.props[el.get("name")] = _coerce(
                    _subst(el.get("value", ""), self.props))
            elif t == "macro":
                self.macros[el.get("name")] = el

    # -- expansion ------------------------------------------------------
    def _expand_into(self, parent: ET.Element, el: ET.Element,
                     props: Dict[str, object]):
        t = _tag(el)
        if t in ("include", "property", "macro"):
            if t == "include":
                self._include(el)
            elif t == "property":
                self.props[el.get("name")] = _coerce(
                    _subst(el.get("value", ""), props))
            else:
                self.macros[el.get("name")] = el
            return
        if t:  # macro invocation <xacro:NAME a="..."/>
            macro = self.macros.get(t)
            if macro is None:
                msg = f"xacro macro {t!r} not defined (after includes)"
                if self.strict:
                    raise KeyError(msg)
                logger.warning("%s; dropping the element", msg)
                return
            call_props = dict(props)
            # defaults from params="a b:=1 c:='0 0 0'"
            for spec in (macro.get("params") or "").split():
                if ":=" in spec:
                    name, default = spec.split(":=", 1)
                    call_props[name] = _coerce(default.strip("'\""))
            for k, v in el.attrib.items():
                call_props[k] = _coerce(_subst(v, props))
            if "direction" in call_props:
                call_props["_dir_rpy"] = _DIR_RPY.get(
                    str(call_props["direction"]), _DIR_RPY["z"])
            for child in list(macro):
                self._expand_into(parent, child, call_props)
            return
        # plain element: substitute attributes/text, recurse
        out = ET.SubElement(parent, el.tag)
        for k, v in el.attrib.items():
            out.set(k, _subst(v, props))
        if el.text and el.text.strip():
            out.text = _subst(el.text, props)
        for child in list(el):
            self._expand_into(out, child, props)

    def expand(self, root: ET.Element) -> ET.Element:
        self._collect_defs(root)
        out = ET.Element(root.tag)
        for k, v in root.attrib.items():
            if not k.startswith("xmlns") and _XACRO_NS not in k:
                out.set(k, _subst(v, self.props))
        for el in list(root):
            self._expand_into(out, el, dict(self.props))
        return out


def expand_xacro(source: str, packages: Optional[Dict[str, str]] = None,
                 strict: bool = False) -> str:
    """Expand a xacro document (text or file path) to plain URDF text.

    ``packages`` maps ROS package names to directories for
    ``$(find pkg)`` includes. With ``strict=False`` (default),
    unresolvable includes/macros warn and fall back to the builtin macro
    library — the reference's environment files only need
    ``collision_capsule`` from their includes.
    """
    base_dir = None
    text = source
    if "\n" not in source and Path(source).is_file():
        base_dir = Path(source).parent
        text = Path(source).read_text()
    root = ET.fromstring(text)
    exp = _Expander(packages=packages, base_dir=base_dir, strict=strict)
    out = exp.expand(root)
    return ET.tostring(out, encoding="unicode")
