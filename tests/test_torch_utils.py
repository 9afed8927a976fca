"""``mini_mcmc_torch.utils`` on the CPU: ``Timer``, ``time_blocked`` and
``profiling.step_timer`` as tests/test_utils.py holds the JAX package's,
and ``profiling.trace``, which writes a ``torch.profiler`` Chrome trace
that parses as JSON and names the ``aten::`` operations of its block.
"""

import json
import os

import torch

from mini_mcmc_torch import utils
from mini_mcmc_torch.utils import Timer, profiling, time_blocked

torch.set_num_threads(1)


def test_timer_logs_elapsed(capsys):
    t = Timer()
    elapsed = t.log("phase one")
    out = capsys.readouterr().out
    assert out.startswith("[timer] phase one: ") and out.endswith(" ms\n")
    assert elapsed >= 0.0
    t.reset()
    assert t.log("phase two") >= 0.0


def test_step_timer_and_time_blocked():
    result, secs = profiling.step_timer(lambda x: torch.sum(x * x),
                                        torch.ones((64, 64)), repeats=2)
    assert float(result) == 64.0 * 64.0 and secs >= 0.0
    # any nesting of tensors comes back as it went in
    (a, b, c), secs = time_blocked(
        lambda x: (x + 1, {"k": x * 2, "n": 4}, [x - 1]), torch.ones(3))
    assert torch.equal(a, torch.full((3,), 2.0)) and secs >= 0.0
    assert b["n"] == 4 and torch.equal(c[0], torch.zeros(3))
    assert utils.time_blocked is time_blocked


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir) as where:
        assert where == log_dir
        x = torch.randn((32, 32), generator=torch.Generator().manual_seed(0))
        (x @ x).sum()
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(os.path.join(log_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert "aten::mm" in names and "aten::sum" in names
    # a second block writes a second file beside the first
    with profiling.trace(log_dir):
        torch.ones(2).add_(1)
    assert len(os.listdir(log_dir)) == 2
