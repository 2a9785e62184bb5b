"""The port's user examples, run through their ``main(argv)`` on the CPU
at the reference's smoke sizes.

``examples/quickstart_torch.py`` (DSE → PBQP → baselines → execute →
compile) at 28², scale 0.1, and ``examples/serve_cnn_torch.py --smoke``
alone and with ``--models 2``, ``--pipeline-depth 2 --chaos --max-queue
4`` and ``--precision auto``. Each run must return 0 — its own checks
(the exact plan, the spot checks at rtol 2e-2 / atol 2e-3, outcome
conservation) raise or return nonzero otherwise — and the test reads the
spot checks and the outcome ledger back from its output. The LM examples,
``examples/train_lm_torch.py`` and ``examples/serve_lm_torch.py``, run
their reduced configs: three training steps with the checkpoint directory
in a temporary one, and the six served requests.
``examples/algorithm_mapping_tour_torch.py`` (the planner only) prints
each family's line as the reference's ``examples/algorithm_mapping_tour.py``
does, and each is held to the reference's: convs, reductions and the
exact flag equal, OPT µs and the greedy gain within 1e-6 relative, the
same algorithm mix.
"""
import ast
import importlib.util
import json
import re
from pathlib import Path

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite's workers share the cores, and
    torch's thread pool, oversubscribed, wakes slower than the small CPU
    ops it would split (on an eight-core host, a reduced GoogleNet's max
    pool took ~16 ms on eight threads, ~0.03 ms on one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _spot_errors(out: str):
    return [float(m) for m in re.findall(
        r"vs eager reference: max\|delta\| = (\S+)", out)]


def _conserved(stats: dict) -> bool:
    rb = stats["robustness"]
    return sum(rb["outcomes"].values()) + rb["pending"] == stats["submitted"]


def test_quickstart_runs_and_checks(capsys):
    main = _load("quickstart_torch").main
    assert main(["--device", "cpu", "--res", "28", "--scale", "0.1"]) == 0
    out = capsys.readouterr().out
    assert "PBQP optimal mapping (exact=True)" in out
    for pol in ("im2col", "kn2row", "winograd"):
        assert f"vs {pol}" in out
    errs = [float(m) for m in re.findall(r"max\|Δ\| (?:vs eager )?= (\S+)",
                                         out)]
    assert len(errs) == 2 and max(errs) < 2e-3


@pytest.mark.parametrize("flags, n_models", [
    ((), 1),
    (("--models", "2"), 2),
    # --chaos arms deadline shedding on the real clock: the SLO is set so
    # far out that a host slowed by other test workers cannot shed every
    # request before its first tick ("no request completed"); the burst
    # still overflows --max-queue 4.
    (("--pipeline-depth", "2", "--chaos", "--max-queue", "4",
      "--slo-ms", "60000"), 1),
    (("--precision", "auto"), 1)])
def test_serve_cnn_smoke(capsys, flags, n_models):
    main = _load("serve_cnn_torch").main
    assert main(["--device", "cpu", "--smoke", *flags]) == 0
    out = capsys.readouterr().out
    errs = _spot_errors(out)
    assert len(errs) == n_models and max(errs) < 2e-3
    stats = json.loads(out[out.index("\n{") + 1:])
    per_model = (list(stats["models"].values()) if n_models > 1
                 else [stats])
    assert len(per_model) == n_models
    for s in per_model:
        assert _conserved(s)
        assert s["submitted"] == (12 if n_models == 1 else 6)
    if "--chaos" in flags:
        s = per_model[0]
        assert s["robustness"]["outcomes"]["rejected_full"] > 0
        assert s["pipeline"]["depth"] == 2
    if "--precision" in flags:
        assert stats["precision"]["calibrated"]
        assert stats["precision"]["mix"]["int8"] > 0


def test_serve_cnn_refuses_multi_model_with_single_model_knobs():
    main = _load("serve_cnn_torch").main
    with pytest.raises(SystemExit, match="--models"):
        main(["--device", "cpu", "--smoke", "--models", "2", "--chaos"])


def test_train_lm_runs_reduced(capsys, tmp_path):
    main = _load("train_lm_torch").main
    assert main(["--device", "cpu", "--reduced", "--steps", "3",
                 "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    steps = [line for line in out.splitlines() if line.startswith("step ")]
    assert len(steps) == 1 and steps[0].startswith("step     0")
    assert "on device cpu" in steps[0]
    assert "done: {'completed': 3, 'restarts': 0}" in out
    assert not any(tmp_path.rglob("*.COMMITTED"))    # first commit at 50


def test_serve_lm_runs_reduced(capsys):
    main = _load("serve_lm_torch").main
    assert main(["--device", "cpu", "--reduced"]) == 0
    lines = capsys.readouterr().out.splitlines()
    streams = [json.loads(line.split(": ", 1)[1]) for line in lines
               if line.startswith("request ")]
    assert len(streams) == 6 and all(len(s) == 8 for s in streams)
    assert "48 tokens" in lines[-1] and "device cpu" in lines[-1]


TOUR_LINE = re.compile(r"^(\S+)\s+convs=\s*(\d+) reductions=\s*(\d+) "
                       r"exact=(True|False)\s+OPT=\s*(\S+)µs\s+greedy "
                       r"\+\s*(\S+)%\s+mix=(\{.*\})$")


def _tour(out: str):
    rows = [TOUR_LINE.match(line) for line in out.splitlines()]
    assert rows and all(rows), out
    return [(m[1], int(m[2]), int(m[3]), m[4], float(m[5]), float(m[6]),
             ast.literal_eval(m[7])) for m in rows]


def test_algorithm_mapping_tour_matches_the_reference(capsys):
    _load("algorithm_mapping_tour").main()
    want = _tour(capsys.readouterr().out)
    assert _load("algorithm_mapping_tour_torch").main([]) == 0
    got = _tour(capsys.readouterr().out)
    assert [row[0] for row in got] == [row[0] for row in want] == [
        "googlenet", "inception_v4", "vgg16", "alexnet", "resnet18"]
    for g, w in zip(got, want):
        assert g[1:4] == w[1:4], g[0]                 # convs, reductions, exact
        assert g[4] == pytest.approx(w[4], rel=1e-6)  # OPT µs
        assert g[5] == pytest.approx(w[5], rel=1e-6)  # greedy gain %
        assert g[6] == w[6], g[0]                     # the mix
