"""JSON plot-data sidecar dumps.

Schema-compatible with the reference's ``plots/PLOT_DATA_FORMAT.md``
(`agimus_controller/plots/dump_utils.py:5`) so downstream tooling can
consume either engine's dumps: the JSON keys and their meanings are part of
the wire format; everything else here is local.

Port of the JAX package's `plots/dump_utils.py` (numpy; a copy).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

# PLOT_DATA_FORMAT.md schema: required series arrays then optional styling
# lists (empty list = "use defaults" downstream).
_ARRAY_KEYS = ("time", "values")
_STYLE_KEYS = ("labels", "ylabels", "semilogs", "ylimits", "colors")


def _listify(x):
    """JSON-safe conversion: device/np arrays -> nested lists, None -> []."""
    if x is None:
        return []
    if hasattr(x, "tolist"):
        return x.tolist()
    return np.asarray(x).tolist() if isinstance(x, (tuple,)) else list(x)


def dump_plot_data(filename, title: str, time, values, **style):
    """Write one figure's data + metadata sidecar; returns the dict written.

    ``style`` accepts the optional schema keys (labels, ylabels, semilogs,
    ylimits, colors); unknown keys are rejected to keep dumps consumable.
    """
    unknown = set(style) - set(_STYLE_KEYS)
    if unknown:
        raise TypeError(f"unknown plot-dump keys: {sorted(unknown)}")
    payload = {"title": title}
    payload.update(
        (k, np.asarray(v).tolist()) for k, v in (("time", time), ("values", values))
    )
    payload.update((k, _listify(style.get(k))) for k in _STYLE_KEYS)
    Path(filename).write_text(json.dumps(payload, indent=2))
    return payload


def dump_filename(dump_path, title: str) -> Path:
    """`<title>_plotdata.json` with spaces underscored (reference naming)."""
    return Path(dump_path) / (title.replace(" ", "_") + "_plotdata.json")
