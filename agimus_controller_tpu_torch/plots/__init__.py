"""Observability: plot helpers + JSON plot-data dumps (reference side layer:
`agimus_controller/plots/`). Matplotlib is optional — every plotting entry
point works headless by dumping the `PLOT_DATA_FORMAT.md`-compatible JSON.
Port of the JAX package's `plots/`."""

from .dump_utils import dump_plot_data
from .pin_utils import get_p_, get_rpy_, get_u_grav, get_v_, get_w_
from .plots_utils import plot_mpc_data, plot_values
