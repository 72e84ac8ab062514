"""The benchmark's files load by name, a new cell or metric is found with
no edit, the generator is deterministic, and the frozen formulas give the
headline's bounds."""
import json
import math
import shutil

import pytest
import torch

from portbench import harness, program, roofline
from portbench.reference import torchgate as ref

from ._small import CELLS, ROOT, small_plan


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    plan = harness.load_plan(cell, ROOT)
    assert plan.config["gate"]["sr"] == 8000 and plan.limits
    assert {m["name"] for m in plan.end_to_end} >= {"setup_s"}
    assert len(plan.end_to_end) >= 2 and plan.per_layer
    for m in plan.end_to_end + plan.per_layer:
        assert callable(harness.reader(plan, m["name"]))


def test_every_file_named_in_benchmark_exists():
    bench = _bench()
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "portbench" / "cells" / f"{w['name']}.json").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()


def test_new_cell_and_metric_need_no_edit(tmp_path):
    """A configuration, a cell and a per-layer metric added as new files
    and list entries only are found and read."""
    bench = _copy(tmp_path)
    config = json.loads((ROOT / "portbench" / "configs" / "torchgate_ns_8k.json").read_text())
    config["gate"]["sr"] = 16000
    (tmp_path / "portbench" / "configs" / "torchgate_ns_16k.json").write_text(json.dumps(config))
    bench["configs"].append({"name": "torchgate_ns_16k", "source": "a test configuration",
                             "file": "portbench/configs/torchgate_ns_16k.json",
                             "reduced": [], "why": "a test configuration"})
    bench["workloads"].append({"name": "tg8k_ns_batch_b", "config": "torchgate_ns_16k",
                               "traffic": "batch_b", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "calls_traced", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "gate_audio_s_per_s", "workloads": ["tg8k_ns_batch_b"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((ROOT / "portbench" / "traffic" / "batch_256x10s.json").read_text())
    mix["rows"] = 2
    (tmp_path / "portbench" / "traffic" / "batch_b.json").write_text(json.dumps(mix))
    (tmp_path / "portbench" / "cells" / "tg8k_ns_batch_b.json").write_text(
        json.dumps({"limits": {"row_gap": 1e-3}}))
    (tmp_path / "portbench" / "metrics" / "calls_traced.py").write_text(
        "def read(ctx):\n    return ctx.trace_calls\n")
    plan = harness.load_plan("tg8k_ns_batch_b", tmp_path)
    assert plan.traffic["rows"] == 2 and plan.config["gate"]["sr"] == 16000
    assert [m["name"] for m in plan.per_layer] == ["calls_traced"]
    ctx = harness.Context(plan=plan, shapes=roofline.shapes(plan.config, plan.traffic, 4),
                          setup_s=1.0, window=harness.Window(), trace_calls=7)
    assert harness.reader(plan, "calls_traced")(ctx) == 7


@pytest.mark.parametrize("cell", ["tg8k_ns_batch", "tg8k_ns_long"])
def test_generator_is_deterministic_per_seed(cell):
    plan = small_plan(cell)
    a = harness.make_pool(plan, 2**31 + 5, "cpu")
    b = harness.make_pool(plan, 2**31 + 5, "cpu")
    c = harness.make_pool(plan, 2**31 + 6, "cpu")
    for (xa, ca), (xb, cb), (xc, _) in zip(a, b, c):
        assert torch.equal(xa, xb) and torch.equal(ca, cb)
        assert xa.shape == xc.shape and not torch.equal(xa, xc)
        assert torch.isfinite(xa).all() and xa.abs().max() < 1.5


def test_frozen_formulas_give_the_headline_bounds():
    """960 s of 48 kHz mono in reduce_noise's 77 views of 660,000 samples
    (2,579 frames x 513 bins): A 1.00 GB, F and E 1.22, C 0.82, D 1.41."""
    config = {"gate": {"sr": 48000, "n_fft": 1024, "win_length": 1024, "hop_length": 256,
                       "freq_mask_smooth_hz": 500, "time_mask_smooth_ms": 50},
              "dtype": "float32"}
    traffic = {"rows": 1, "seconds": 960, "chunk_size": 600000,
               "padding": 30000}
    s = roofline.shapes(config, traffic, 4)
    assert (s["views"], s["frames"], s["bins"]) == (77, 2579, 513)
    kernels = json.loads((ROOT / "portbench" / "kernels.json").read_text())
    # PERF.md's kernel table: GB moved (0.815 printed as 0.82) and the bound's ms
    want = {"A_spectra": (1.00, 0.298), "F_mask": (1.22, 0.365), "E_mask": (1.22, 0.365),
            "C_smooth": (0.82, 0.243), "D_istft": (1.41, 0.420)}
    for name, (gb, ms) in want.items():
        moved, _ = roofline.kernel_work(kernels[name], s)
        t, by = roofline.least_seconds(*roofline.kernel_work(kernels[name], s))
        assert abs(moved / 1e9 - gb) <= 0.006 and by == "bytes", name
        assert math.isclose(t * 1e3, ms, abs_tol=1e-3), name


def test_formulas_refuse_anything_but_arithmetic():
    assert roofline.evaluate("2*x + log2(8)", {"x": 1}) == 5.0
    with pytest.raises(ValueError):
        roofline.evaluate("__import__('os')", {})


@pytest.mark.parametrize("cell", ["tg8k_ns_batch", "tg8k_st_batch"])
def test_reference_agrees_with_the_port_on_the_cpu(cell):
    plan = small_plan(cell)
    gate = program.build(plan.config, torch.device("cpu"))
    x, _ = harness.make_pool(plan, 3, "cpu")[0]
    got = plan.calls.forward(gate, x)
    want = ref.gate(x, plan.config["gate"])
    gap = ((got.double() - want.double()).norm(dim=-1) / want.double().norm(dim=-1)).max()
    assert got.shape == want.shape and gap < 1e-5


NEW_KIND = '''"""TPUGate.forward on the first half of each row: a kind added as a file."""
import torch

from portbench import check, faults as fx

STAMPS = ("call",)


def forward(gate, x):
    return gate(x)


def step(gate, x, clean, traffic, mark):
    mark()
    with torch.inference_mode():
        out = forward(gate, x[:, :x.shape[-1] // 2])
    mark()
    return out


def readings(cfg, traffic, x, clean, out):
    want = check.reference_rows(cfg, x[:, :x.shape[-1] // 2])
    return {"row_gap": float(check.row_gaps(out, want).max())}


CONTROL = ("forward", fx.bf16_input)


def faults(config):
    return {"altered": ("forward", fx.louder_row)}
'''


def _copy(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return _bench()


def test_new_kind_of_call_needs_no_edit(tmp_path):
    """A kind of call (its timed entry and its check), a mix of that kind
    and a cell added as new files and list entries only run whole: a sound
    run is correct and reads its metrics, a planted fault is not."""
    import time

    from portbench.faults import replaced

    bench = _copy(tmp_path)
    (tmp_path / "portbench" / "kinds" / "gate_half.py").write_text(NEW_KIND)
    mix = json.loads((ROOT / "portbench" / "traffic" / "batch_256x10s.json").read_text())
    mix.update(kind="gate_half", rows=3, seconds=1.0, pool=2, warmup_calls=1, check_calls=2)
    (tmp_path / "portbench" / "traffic" / "half_3x1s.json").write_text(json.dumps(mix))
    (tmp_path / "portbench" / "cells" / "tg8k_ns_half.json").write_text(
        json.dumps({"limits": {"row_gap": 1e-4}}))
    bench["workloads"].append({"name": "tg8k_ns_half", "config": "torchgate_ns_8k",
                               "traffic": "half_3x1s", "chips": 1, "why": "a test cell"})
    bench["end_to_end"][0]["workloads"].append("tg8k_ns_half")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    plan = harness.load_plan("tg8k_ns_half", tmp_path)
    r = harness.run_cell(plan, 2**31 + 3, 0.2, False, "cpu", time.perf_counter())
    assert r["correct"] and set(r["metrics"]) == {"gate_audio_s_per_s", "setup_s"}
    with replaced(plan.calls, *plan.calls.faults(plan.config)["altered"]):
        r = harness.run_cell(plan, 2**31 + 3, 0.2, False, "cpu", time.perf_counter())
    assert not r["correct"]


def test_a_kind_with_no_module_is_refused(tmp_path):
    bench = _copy(tmp_path)
    mix = json.loads((ROOT / "portbench" / "traffic" / "batch_256x10s.json").read_text())
    mix["kind"] = "no_such_kind"
    (tmp_path / "portbench" / "traffic" / "odd.json").write_text(json.dumps(mix))
    bench["workloads"].append({"name": "odd", "config": "torchgate_ns_8k",
                               "traffic": "odd", "chips": 1, "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "portbench" / "cells" / "odd.json").write_text('{"limits": {}}')
    with pytest.raises(KeyError, match="no_such_kind"):
        harness.load_plan("odd", tmp_path)


@pytest.mark.parametrize("dtype,size", [("float32", 4), ("bfloat16", 2)])
def test_the_inputs_and_the_bytes_follow_the_configuration_dtype(dtype, size):
    plan = small_plan("tg8k_ns_batch")
    plan.config["dtype"] = dtype
    x, clean = harness.make_pool(plan, 7, "cpu")[0]
    assert x.dtype == getattr(torch, dtype) and clean.dtype == torch.float32
    s = roofline.shapes(plan.config, plan.traffic, x.element_size())
    assert s["sb"] == s["pb"] == s["ob"] == size
