"""The port's copies of the JAX demos (`examples/*_torch.py`): each demo's
`main` runs with `--device cpu` at a tiny size (a few ticks, a short
horizon, a small batch) and prints its result. `plot_run` and `debug_ocp`
read the recording `pick_and_place` writes."""

import contextlib
import importlib.util
import io
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
DEMOS = ("pick_and_place", "dummy_mpc", "batch_scenarios", "plot_run",
         "debug_ocp", "ocp_dsl_roundtrip", "model_sensitivity")


def _demo(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", ROOT / "examples" / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    """A short pick-and-place run: (its `MPCRecorder` file, its output)."""
    out = tmp_path_factory.mktemp("pick_and_place")
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        _demo("pick_and_place").main(["--ticks", "2", "--horizon", "3",
                                      "--out", str(out), "--device", "cpu"])
    return out / "mpc_run.npz", text.getvalue()


def _argv(name, run, out):
    return {
        "dummy_mpc": ["--ticks", "3", "--horizon", "3"],
        "batch_scenarios": ["--batch", "4", "--horizon", "5", "--iters",
                            "2"],
        "plot_run": [str(run), "--out", str(out)],
        "debug_ocp": [str(run), "--values", "10", "--T", "3", "--out",
                      str(out)],
        "ocp_dsl_roundtrip": [],
        "model_sensitivity": [],
    }[name] + ["--device", "cpu"]


EXPECT = {"pick_and_place": "tracking error", "dummy_mpc": "tracking err",
          "batch_scenarios": "scenario solves", "plot_run": "written to",
          "debug_ocp": "sweep plots", "ocp_dsl_roundtrip": "round trip OK",
          "model_sensitivity": "most influential"}


@pytest.mark.parametrize("name", DEMOS)
def test_demo_runs_on_the_cpu(name, recording, tmp_path, capsys):
    run, text = recording
    if name != "pick_and_place":  # the fixture's run is its case
        _demo(name).main(_argv(name, run, tmp_path))
        text = capsys.readouterr().out
    assert EXPECT[name] in text
