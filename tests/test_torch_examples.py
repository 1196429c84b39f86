"""The port's example CLIs (``python -m repro_torch.examples.<name>``) on the
CPU at their smallest flags, against the reference's ``examples/*.py``.

Each CLI keeps its reference's flags, prints its reference's lines and
returns its reference's fields.  Numbers are held equal where no weight
draw enters: quickstart's GR and OPT rows come from the simulator alone
(numpy copies of the reference's, same seeds).  Everything else reads
weights the port draws from ``torch.Generator``s where the reference draws
from ``jax.random`` (the D3QL agent; the DiT services, whose measured
Omega decides early exit and so completions, latency and quality), so
those numbers differ from the reference's and are checked for their
properties instead.
"""
import json
import re

import numpy as np
import pytest

from repro.core import GreedyController as JGreedyController
from repro.core import opt_upper_bound as jopt_upper_bound
from repro.sim import EdgeSimulator as JEdgeSimulator
from repro.sim import SimConfig as JSimConfig
from repro.sim.scenarios import scenario_names as jscenario_names
from repro_torch.examples import quickstart, serve_fleet, serve_gdm, train_agent
from repro_torch.serving.telemetry import validate
from repro_torch.serving.tracing import validate_trace
from repro_torch.sim.scenarios import scenario_names


def _number(line_prefix, text):
    """The first number after ``line_prefix`` on its line of ``text``."""
    for line in text.splitlines():
        if line.strip().startswith(line_prefix):
            return float(re.search(r"-?\d+\.\d+", line[len(line_prefix) + 2:])
                         .group())
    raise AssertionError(f"no line starts with {line_prefix!r}")


def test_quickstart_gr_and_opt_rows_equal_the_reference(monkeypatch, capsys):
    """Training cut to two episodes (the CLI has no flag for it; the
    reference trains 80): the untrained and trained rows read the agent's
    weights; GR and OPT must equal the reference's to the printed digit
    and exactly in value."""
    class Short(quickstart.LearnGDMController):
        def train(self, episodes, **kw):
            return super().train(min(episodes, 2), **kw)

    monkeypatch.setattr(quickstart, "LearnGDMController", Short)
    out = quickstart.main(["--device", "cpu"])
    text = capsys.readouterr().out
    for label in ("env: 16 BSs (4x4 grid), 10 UEs, 2 channels, B=4 blocks",
                  "untrained LEARN-GDM reward:", "training D3QL for 80",
                  "trained LEARN-GDM reward:", "GR (all blocks at PoA):",
                  "OPT full-knowledge bound:", "(expected ordering:"):
        assert label in text, label
    cfg = JSimConfig(num_ues=10, num_channels=2, horizon=40, seed=0)
    jgr = JGreedyController(JEdgeSimulator(cfg)).evaluate(3)
    jopt = jopt_upper_bound(JEdgeSimulator(cfg), seed=9000)
    assert set(out["gr"]) == set(jgr) and set(out["opt"]) == set(jopt)
    for key in jgr:
        assert out["gr"][key] == pytest.approx(jgr[key], rel=1e-12), key
    for key in jopt:
        assert out["opt"][key] == pytest.approx(jopt[key], rel=1e-12), key
    assert _number("GR (all blocks at PoA):", text) == round(jgr["reward"], 2)
    assert _number("OPT full-knowledge bound:", text) == \
        round(jopt["reward"], 2)
    for key in ("untrained", "trained"):
        assert np.isfinite(out[key]["reward"])


def test_train_agent_writes_the_reference_curve_format(tmp_path, capsys):
    assert set(scenario_names()) == set(jscenario_names())
    path = tmp_path / "curve.csv"
    out = train_agent.main(["--episodes", "2", "--scenario", "smoke",
                            "--out", str(path), "--device", "cpu"])
    text = capsys.readouterr().out
    lines = path.read_text().splitlines()
    assert lines[0] == "episode,reward,mse_loss" and len(lines) == 3
    assert [int(row.split(",")[0]) for row in lines[1:]] == [0, 1]
    assert "reward: first 1 eps mean" in text
    assert "greedy eval (batched engine): reward" in text
    assert f"curves -> {path}" in text
    assert set(out["history"]) >= {"reward", "loss"}
    assert np.isfinite(out["eval"]["reward"])
    with pytest.raises(SystemExit):                 # the reference's choices
        train_agent.main(["--engine", "bogus", "--device", "cpu"])


def test_serve_gdm_prints_the_reference_summary(capsys):
    """Omega is measured from DiT services the port draws (reduced
    gdm-dit, as the reference's), so the served numbers follow the port's
    weights; every chain of the trace completes under both policies."""
    out = serve_gdm.main(["--scenario", "smoke", "--train-eps", "2",
                          "--frames", "4", "--engine", "vectorized",
                          "--device", "cpu"])
    text = capsys.readouterr().out
    for label in ("[1/3] measuring Omega(k) from 3 real DiT services (B=4)",
                  "service 0: Omega = 0.000", "[2/3] training learn-gdm",
                  "[3/3] serving 4 quanta", "learned  completed=",
                  "greedy   completed=", "batched execution:",
                  "learned vs greedy objective:"):
        assert label in text, label
    assert set(out) == {"learned", "greedy"}
    for stats in out.values():
        assert {"completed", "submitted", "mean_quality",
                "mean_latency_frames", "p95_latency_frames", "objective",
                "wall_s"} <= set(stats)
        assert 0 < stats["completed"] <= stats["submitted"]
        assert 0.0 < stats["mean_quality"] <= 1.0


@pytest.mark.parametrize("argv", [
    ["--policy", "greedy", "--scheduling", "continuous", "--skew", "0.2"],
    ["--train-eps", "2", "--engine", "vectorized", "--fault-schedule",
     "node-churn", "--recovery-mode", "failover+degrade", "--deadline", "8"],
])
def test_serve_fleet_prints_the_reference_report(argv, tmp_path, capsys):
    tel, trace = tmp_path / "tel.json", tmp_path / "trace.json"
    out = serve_fleet.main(["--scenario", "smoke", "--cells", "2",
                            "--frames", "5", "--telemetry-out", str(tel),
                            "--trace-out", str(trace), "--device", "cpu"]
                           + argv)
    text = capsys.readouterr().out
    for label in ("[1/3] measuring Omega(k) from 3 DiT services",
                  "[2/3] building a 2-cell fleet for 'smoke'",
                  "[3/3] serving the fleet", "fleet: ", "  latency ",
                  "  handovers ", "  cell 0: ", "  cell 1: ", "telemetry: ",
                  "  legs: ", "stacked execution:", "telemetry written to",
                  "critical path (", "trace written to"):
        assert label in text, label
    assert ("resilience: goodput" in text) == ("--fault-schedule" in argv)
    assert ("continuous batching on" in text) == ("continuous" in argv)
    assert len(out["per_cell"]) == 2
    assert out["completed"] <= out["submitted"]
    doc = json.loads(tel.read_text())
    validate(doc)
    assert len(doc["events"]) == 2 * 5         # a quantum per cell and frame
    validate_trace(json.loads(trace.read_text()))
