"""The port's benchmark harness (``maxk_tpu_torch/bench/``,
``ops/gnna.py``, ``ops/spmm.py::spmm_coo``) vs ``maxk_tpu``'s, on the CPU.

Tolerances:
- exact for the numpy copies (``_csr_spmm_numpy``, ``build_parts``, the
  suite specs), for CBSR values and selectors (K4's plain version is
  bit-equal to the JAX ``cbsr_topk``), for the harness's log fields
  (num, graph, dim, k, kernel) and for ``analyze_speedups`` on the same
  records;
- rtol 1e-5 (atol 1e-5 on these sums of ~60 terms in [0, 1)) for the
  float32 sums of ``spmm_gnna``, ``spmm_coo`` and the bf16-operand CBSR
  forward, where only the summation order differs;
- one bfloat16 ulp (rtol 2**-8) for the sampled backward, whose float32
  sums are rounded to bfloat16 on both sides: sums that differ in the
  last float32 bits may round to neighbouring bfloat16 values;
- 1e-6 for the validation records' error fields (``mean_err``,
  ``max_err``, ``bwd_mean_err``), which are ~1e-8 on both sides.

``benchmark_graph`` runs on both packages with ``time_fn`` monkeypatched
to one call, once per module, on one graph: its log, its validation
record and its structure are compared. The JAX package is not changed.
"""

import argparse
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a test worker)
from maxk_tpu.bench import direct_interface as jax_di
from maxk_tpu.bench import harness as jax_harness
from maxk_tpu.bench.timing import TimingResult as JaxTimingResult
from maxk_tpu.ops.gnna import build_parts as jax_build_parts
from maxk_tpu.ops.gnna import spmm_gnna as jax_spmm_gnna
from maxk_tpu.ops.graph import CSRGraph as JaxCSRGraph
from maxk_tpu.ops.spmm import spmm_coo as jax_spmm_coo
from maxk_tpu_torch.bench import harness, kernel_bench, headline, roofline
from maxk_tpu_torch.bench import timing
from maxk_tpu_torch.bench.direct_interface import (DirectMaxKKernels,
                                                   prepare_cbsr_format,
                                                   topk_nonlinearity)
from maxk_tpu_torch.data.loaders import save_csr_binary
from maxk_tpu_torch.data.warp4 import generate_warp4, save_warp4
from maxk_tpu_torch.ops import gnna, spmm as torch_spmm_mod
from maxk_tpu_torch.ops.graph import CSRGraph, DeviceCSR

from conftest import random_graph

BF16_ULP = 2.0 ** -8


def _port(csr: JaxCSRGraph) -> CSRGraph:
    return CSRGraph(csr.indptr, csr.indices, csr.values)


def _with_empty_rows(n: int, seed: int) -> JaxCSRGraph:
    """Weighted graph whose rows 3i and the last 5 rows have no edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n - 5, 8 * n)
    src = src[src % 3 != 0]
    dst = rng.integers(0, n, src.shape[0]).astype(np.int32)
    return JaxCSRGraph.from_coo(src, dst, n, rng.uniform(
        size=src.shape[0]).astype(np.float32))


def _one_call(fn, warmup=0, runs=0, **_):
    """time_fn as one call: the log's fields without the protocol's
    repeats (timing is not what these tests compare)."""
    fn()
    return JaxTimingResult(mean_ms=1.0, min_ms=1.0, max_ms=1.0, runs=1)


def _one_call_torch(fn, warmup=0, runs=0, **_):
    fn()
    return timing.TimingResult(mean_ms=1.0, min_ms=1.0, max_ms=1.0, runs=1)


# -- one graph, one run of each harness ---------------------------------------

BENCH_DIM, BENCH_KS = 64, (8, 16)


@pytest.fixture(scope="module")
def bench_graph():
    return random_graph(n_nodes=200, avg_degree=60.0, seed=5, power_law=True)


def _run(module, one_call, csr, **kw):
    lines = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "time_fn", one_call)
        res = module.benchmark_graph(csr, "tiny", dim=BENCH_DIM, ks=BENCH_KS,
                                     run_coo=True, log=lines.append, **kw)
    return res, lines


@pytest.fixture(scope="module")
def benches(bench_graph):
    jax_res = _run(jax_harness, _one_call, bench_graph)
    torch_res = _run(harness, _one_call_torch, _port(bench_graph),
                     device="cpu")
    return jax_res, torch_res


def _fields(lines):
    """(num, graph, dim, k, kernel) of each `num graph dim_origin dim_k
    kernel time(ms)` line."""
    return [tuple(ln.split()[:5]) for ln in lines if not ln.startswith("#")]


def test_benchmark_graph_log_fields_match_jax(benches):
    (_, jax_lines), (_, torch_lines) = benches
    assert _fields(torch_lines) == _fields(jax_lines)
    assert all(len(ln.split()) == 6 for ln in torch_lines
               if not ln.startswith("#"))
    assert any(ln.startswith("# roofline tiny: not measured on cpu")
               for ln in torch_lines)


def test_benchmark_graph_validation_record_matches_jax(benches):
    (jax_res, _), (torch_res, _) = benches
    a, b = jax_res.validation, torch_res.validation
    assert set(a) == set(b)
    assert a["k"] == b["k"] == BENCH_KS[0]
    assert a["passed"] and b["passed"]
    assert a["n_flagged"] == b["n_flagged"] == 0
    for key in ("mean_err", "max_err", "bwd_mean_err"):
        assert abs(a[key] - b[key]) <= 1e-6, (key, a[key], b[key])


def test_benchmark_graph_result_structure_matches_jax(benches):
    (jax_res, _), (torch_res, _) = benches
    for name in ("graph", "n_nodes", "n_edges", "avg_degree", "dim"):
        assert getattr(torch_res, name) == getattr(jax_res, name)
    for name in ("topk_ms", "forward_ms", "backward_ms", "fused_mask_ms"):
        assert set(getattr(torch_res, name)) == set(BENCH_KS)
    assert torch_res.protocol == harness.PROTOCOL != jax_res.protocol
    assert torch_res.roofline is None          # no H100 model on the CPU
    assert torch_res.coo_ms and torch_res.gnna_ms
    json.dumps(torch_res.as_json())


# -- the numpy copies ---------------------------------------------------------

def test_csr_spmm_numpy_equal_to_jax():
    g = _with_empty_rows(90, seed=3)
    dense = np.random.default_rng(0).normal(size=(90, 12)).astype(np.float32)
    args = (g.indptr, g.indices, g.values, dense)
    ref = jax_harness._csr_spmm_numpy(*args, edges_per_chunk=50)
    out = harness._csr_spmm_numpy(*args, edges_per_chunk=50)
    np.testing.assert_array_equal(out, ref)
    assert not out[::3].any() and not out[-5:].any()


def test_build_parts_equal_to_jax():
    g = random_graph(n_nodes=300, avg_degree=7.0, seed=3, power_law=True)
    ref = jax_build_parts(g, chunk_groups=64)
    out = gnna.build_parts(_port(g), chunk_groups=64)
    for name in ("cols", "weight", "row"):
        np.testing.assert_array_equal(getattr(out, name), getattr(ref, name))
    assert (out.part_size, out.n_nodes, out.n_groups) == \
        (ref.part_size, ref.n_nodes, ref.n_groups)


def test_suite_specs_equal_to_jax():
    for name in ("SUITE_SPECS", "LARGE_SPECS", "SUITE24_SPECS",
                 "PAPER_SPEEDUPS", "DIM_ORIGIN", "DEFAULT_KS"):
        assert getattr(harness, name) == getattr(jax_harness, name), name
    g = harness.synthetic_by_name("s24_cora")
    ref = jax_harness.synthetic_by_name("s24_cora")
    np.testing.assert_array_equal(g.indptr, ref.indptr)
    np.testing.assert_array_equal(g.indices, ref.indices)
    assert harness.synthetic_by_name("no_such_graph") is None


def test_graph_cache_keys_on_size(tmp_path, monkeypatch):
    """A suite graph past the cache's threshold is cached under its name,
    generator, v, d and seed, in a file of the port's own: a spec whose v
    changes regenerates, the same spec loads the file, and a JAX package
    file of the old name in the same directory is never read."""
    monkeypatch.setenv("MAXK_GRAPH_CACHE", str(tmp_path))
    calls = []

    def gen(v, d, seed):
        calls.append((v, d, seed))
        n = len(calls)
        return CSRGraph(np.array([0, n], np.int64),
                        np.zeros(n, np.int32))

    np.savez(tmp_path / "g@power_s1.npz", indptr=np.array([0, 9]),
             indices=np.zeros(9, np.int32))
    first = harness._gen_cached(gen, "power", "g", 500_000, 2.5, 1)
    again = harness._gen_cached(gen, "power", "g", 500_000, 2.5, 1)
    bigger = harness._gen_cached(gen, "power", "g", 500_001, 2.5, 1)
    denser = harness._gen_cached(gen, "power", "g", 500_000, 3.0, 1)
    assert calls == [(500_000, 2.5, 1), (500_001, 2.5, 1),
                     (500_000, 3.0, 1)]
    assert [g.n_edges for g in (first, again, bigger, denser)] == \
        [1, 1, 2, 3]
    assert all(p.name.startswith("torch_") for p in tmp_path.iterdir()
               if p.name != "g@power_s1.npz")


# -- the comparators ----------------------------------------------------------

@pytest.mark.parametrize("chunk_elems", [None, 64])
def test_spmm_gnna_matches_jax(chunk_elems, monkeypatch):
    if chunk_elems:
        monkeypatch.setattr(gnna, "_CHUNK_ELEMS", chunk_elems)
    g = random_graph(n_nodes=300, avg_degree=7.0, seed=3, power_law=True)
    x = np.random.default_rng(0).uniform(
        size=(g.n_nodes, 16)).astype(np.float32)
    ref = np.asarray(jax_spmm_gnna(jax_build_parts(g, chunk_groups=64),
                                   jnp.asarray(x)))
    out = gnna.spmm_gnna(gnna.build_parts(_port(g), chunk_groups=64),
                         torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunk_elems", [None, 64])
def test_spmm_coo_matches_jax(chunk_elems, monkeypatch):
    if chunk_elems:
        monkeypatch.setattr(torch_spmm_mod, "_COO_CHUNK_ELEMS", chunk_elems)
    g = _with_empty_rows(120, seed=4)
    rows, cols = g.to_coo()
    x = np.random.default_rng(1).uniform(
        size=(g.n_nodes, 16)).astype(np.float32)
    ref = np.asarray(jax_spmm_coo(jnp.asarray(rows.astype(np.int32)),
                                  jnp.asarray(cols.astype(np.int32)),
                                  jnp.asarray(g.values), jnp.asarray(x),
                                  g.n_nodes))
    out = torch_spmm_mod.spmm_coo(torch.from_numpy(rows),
                                  torch.from_numpy(cols),
                                  torch.from_numpy(g.values),
                                  torch.from_numpy(x), g.n_nodes)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


# -- records and the speedup analysis -----------------------------------------

def _jax_records():
    common = dict(dim=256, gnna_ms=2.0, validation=None,
                  backward_baseline_ms=1.5, coo_ms=9.0)
    return [
        jax_harness.GraphBenchResult(
            graph="hi", n_nodes=1000, n_edges=80_000, avg_degree=80.0,
            baseline_ms=1.2, topk_ms={16: 0.1, 32: 0.12},
            forward_ms={16: 0.6, 32: 0.9}, backward_ms={16: 0.5, 32: 0.7},
            fused_mask_ms={16: 1.0, 32: 1.1}, roofline={"floor_ms": 0.1},
            **common),
        jax_harness.GraphBenchResult(
            graph="hi2", n_nodes=500, n_edges=30_000, avg_degree=60.0,
            baseline_ms=0.8, topk_ms={16: 0.05}, forward_ms={16: 0.5},
            backward_ms={16: 0.4}, **common),
        jax_harness.GraphBenchResult(
            graph="lo", n_nodes=1000, n_edges=5_000, avg_degree=5.0,
            baseline_ms=0.3, topk_ms={16: 0.1}, forward_ms={16: 0.2},
            backward_ms={16: 0.2}, **common),
    ]


def test_from_json_on_jax_records_and_analyze_speedups():
    jax_rows = _jax_records()
    rows = [harness.GraphBenchResult.from_json(
        json.loads(json.dumps(r.as_json()))) for r in jax_rows]
    for r, ref in zip(rows, jax_rows):
        assert dataclasses.asdict(r) == dataclasses.asdict(ref)
        assert r.protocol == jax_harness.PROTOCOL != harness.PROTOCOL
        for k in ref.forward_ms:
            assert r.speedup(k) == ref.speedup(k)
            assert r.backward_speedup(k) == ref.backward_speedup(k)
            assert r.fused_mask_speedup(k) == ref.fused_mask_speedup(k)
    lines, ref_lines = [], []
    summary = harness.analyze_speedups(rows, log=lines.append)
    ref = jax_harness.analyze_speedups(jax_rows, log=ref_lines.append)
    assert summary == ref and lines == ref_lines
    assert set(summary["forward"]) == {16, 32}
    # A record without a stamp is protocol 1, never current.
    d = jax_rows[0].as_json()
    del d["protocol"]
    assert harness.GraphBenchResult.from_json(d).protocol == 1


# -- the H100 roofline --------------------------------------------------------

def test_roofline_arithmetic_hand_computed():
    # Row 0: 3 edges, row 1: none, row 2: 5 edges; at S = 2 rows 0 and 2
    # split into 2 and 3 segments.
    csr = CSRGraph.from_coo(np.array([0, 0, 0, 2, 2, 2, 2, 2]),
                            np.array([1, 2, 0, 0, 1, 2, 1, 0], np.int32), 3)
    plan = DeviceCSR.from_csr(csr, "cpu", seg_len=2).plan
    assert (plan.n_segments, plan.fin_row.shape[0], plan.n_partials) == \
        (5, 3, 5)
    # cast 3*4*(4+2) + indptr 4*8 + segments 5*16 + fin 3*4 + fin_ptr 4*8
    # + edges 8*8 + x 3*4*2 + out 3*4*4 + partials 5*4*4*2
    assert roofline.stream_bytes(3, 8, 4, plan) == \
        72 + 32 + 80 + 12 + 32 + 64 + 24 + 48 + 160
    model = dict(hbm_bytes_per_s=1e6, fp32_flops_per_s=2e5,
                 gather_bytes_per_s=1e5)
    r = roofline.audit_spmm(3, 8, 4, 2.0, plan, model=model)
    assert r.stream_ms == pytest.approx(0.524)
    assert r.gather_ms == pytest.approx(0.64)        # 8*4*2 B
    assert r.fma_ms == pytest.approx(0.32)           # 2*8*4 ops
    assert r.floor_ms == pytest.approx(0.64) and r.bound == "gather"
    assert r.serial_ms == pytest.approx(1.484)
    assert r.efficiency == pytest.approx(0.742)
    assert r.achieved_gnnz_s == pytest.approx(4e-6)
    assert "gather-bound" in r.summary()
    with pytest.raises(ValueError, match="gather rate"):
        roofline.audit_spmm(3, 8, 4, 2.0, plan,
                            model=dict(model, gather_bytes_per_s=None))
    with pytest.raises(ValueError, match="CUDA"):
        roofline.gather_probe(torch.zeros(3, 4, dtype=torch.bfloat16),
                              torch.zeros(8, dtype=torch.int32))


def test_roofline_int8_arithmetic_hand_computed():
    """K7's model: one byte a gathered column; the column scale quantizes
    x in the call (two reads of f32 x, the int8 write, D scales), the row
    scale reads V scales and gathers one more 4-byte scale an edge."""
    csr = CSRGraph.from_coo(np.array([0, 0, 0, 2, 2, 2, 2, 2]),
                            np.array([1, 2, 0, 0, 1, 2, 1, 0], np.int32), 3)
    plan = DeviceCSR.from_csr(csr, "cpu", seg_len=2).plan
    # indptr, segments, fin, fin_ptr, edges, the int8 x, out, partials
    common = 32 + 80 + 12 + 32 + 64 + 3 * 4 + 48 + 160
    assert roofline.stream_bytes(3, 8, 4, plan, 1, 4, "column") == \
        3 * 4 * (4 + 4 + 1) + 4 * 4 + common
    assert roofline.stream_bytes(3, 8, 4, plan, 1, 4, "row") == \
        3 * 4 + common
    model = dict(hbm_bytes_per_s=1e6, fp32_flops_per_s=2e5,
                 gather_bytes_per_s=1e5)
    col = roofline.audit_spmm(3, 8, 4, 2.0, plan, 1, model=model,
                              scale="column")
    row = roofline.audit_spmm(3, 8, 4, 2.0, plan, 1, model=model,
                              scale="row")
    assert col.gather_ms == pytest.approx(0.32)      # 8*4*1 B
    assert row.gather_ms == pytest.approx(0.64)      # 8*(4*1 + 4) B
    assert col.stream_ms == pytest.approx(0.564)
    assert row.stream_ms == pytest.approx(0.452)
    assert col.fma_ms == row.fma_ms == pytest.approx(0.32)


def test_time_fn_on_cpu_counts_calls():
    calls = []
    r = timing.time_fn(lambda: calls.append(1) or torch.zeros(1), warmup=3,
                       runs=5)
    assert len(calls) == 3 + 5 and r.runs == 5
    assert 0 <= r.min_ms <= r.mean_ms <= r.max_ms
    assert r.nnz_per_s(1000) > 0


# -- the direct interface -----------------------------------------------------

@pytest.fixture(scope="module")
def direct():
    g = random_graph(n_nodes=150, avg_degree=10.0, seed=4, power_law=True)
    return (jax_di.DirectMaxKKernels(g, graph_name="tgraph"),
            DirectMaxKKernels(_port(g), graph_name="tgraph", device="cpu"))


def test_direct_interface_matches_jax(direct):
    jdk, dk = direct
    x = np.random.default_rng(0).normal(size=(150, 64)).astype(np.float32)
    v, s = dk.generate_maxk_sparse_data(x, k=8)
    v_ref, s_ref = jdk.generate_maxk_sparse_data(x, k=8)
    np.testing.assert_array_equal(s, s_ref)
    np.testing.assert_array_equal(v.view(np.uint32),
                                  np.asarray(v_ref).view(np.uint32))
    out, t = dk.run_forward_kernel(v, s, dim=64, timing=False)
    ref, _ = jdk.run_forward_kernel(v_ref, s_ref, dim=64, timing=False)
    assert t is None
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    dy = np.random.default_rng(2).normal(size=(150, 64)).astype(np.float32)
    gout, tb = dk.run_backward_kernel(dy, s)
    gref, _ = jdk.run_backward_kernel(dy, s_ref, timing=False)
    np.testing.assert_allclose(gout, np.asarray(gref, np.float32),
                               rtol=BF16_ULP, atol=1e-6)
    assert gout.shape == (150, 8) and tb.runs == 4
    res = dk.validate_against_cusparse(x, k=8)
    assert res["passed"], res


def test_direct_interface_benchmark_and_metadata(direct, tmp_path):
    _, dk = direct
    x = np.random.default_rng(0).normal(size=(150, 16)).astype(np.float32)
    res = dk.benchmark_all_k_values(x, k_values=(4, 8))
    assert set(res) == {4, 8}
    for r in res.values():
        assert {"topk_ms", "forward_ms", "backward_ms"} <= set(r)
    w = generate_warp4(dk.csr)
    save_warp4(w, tmp_path, "tgraph")
    np.testing.assert_array_equal(dk.load_warp4_metadata(tmp_path), w)
    xt = torch.from_numpy(x)
    vals, _ = prepare_cbsr_format(xt, 4)
    assert tuple(vals.shape) == (150, 4)
    assert int((topk_nonlinearity(xt, 4) != 0).sum(dim=1).max()) <= 4


# -- the two entry points -----------------------------------------------------

@pytest.fixture(scope="module")
def graph_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("graphs")
    save_csr_binary(_port(random_graph(n_nodes=64, avg_degree=6.0, seed=9)),
                    d, "tiny")
    return d


def _kb(graph_dir, out, *extra):
    return kernel_bench.main(["tiny", "--graphs", str(graph_dir), "--dim",
                              "16", "--ks", "4", "--device", "cpu",
                              "--json", str(out), *extra])


def test_kernel_bench_json_and_resume(graph_dir, tmp_path, capsys):
    out = tmp_path / "suite.json"
    assert _kb(graph_dir, out) == 0
    d = json.loads(out.read_text())
    assert d["protocol"] == harness.PROTOCOL
    assert d["device"] == {"platform": "cpu"}
    (row,) = d["results"]
    assert row["graph"] == "tiny" and row["validation"]["passed"]
    assert row["protocol"] == harness.PROTOCOL
    assert "0 tiny 16 4 topk" in capsys.readouterr().out

    # A JAX-stamped row of the same graph is re-measured; a current row
    # of another graph is kept as it is.
    jax_row = dict(_jax_records()[2].as_json(), graph="tiny")
    kept = dict(row, graph="other", baseline_ms=123.0)
    out.write_text(json.dumps(dict(results=[jax_row, kept])))
    assert _kb(graph_dir, out, "--resume-json", str(out)) == 0
    assert "stale-protocol rows dropped, will re-measure: tiny" in \
        capsys.readouterr().err
    rows = {r["graph"]: r for r in json.loads(out.read_text())["results"]}
    assert rows["other"]["baseline_ms"] == 123.0
    assert rows["tiny"]["protocol"] == harness.PROTOCOL
    assert rows["tiny"]["n_nodes"] == 64


def test_kernel_bench_fill_coo(graph_dir, tmp_path):
    row = dict(_jax_records()[2].as_json(), graph="tiny", dim=16,
               protocol=harness.PROTOCOL, coo_ms=None)
    p = tmp_path / "suite.json"
    p.write_text(json.dumps(dict(results=[row], partial=True)))
    args = argparse.Namespace(json=str(p), resume_json=str(p),
                              graphs=str(graph_dir), ks=[4], only=None,
                              device="cpu")
    assert kernel_bench._fill_coo(args) == 0
    d = json.loads(p.read_text())
    assert d["results"][0]["coo_ms"] > 0 and d["partial"] is True
    assert d["results"][0]["forward_ms"] == {"16": 0.2}    # untouched


def test_headline_prints_one_json_line(graph_dir, capsys):
    assert headline.main(["--graphs", str(graph_dir), "--graph", "tiny",
                          "--dim", "64", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    d = json.loads(lines[0])
    assert set(d) == {"metric", "value", "unit", "vs_baseline",
                      "train_step_ms"}
    assert d["metric"] == "maxk_spgemm_fwd_nnz_per_s_k32_d64"
    # Gnnz/s rounded to 4 places, as bench.py prints it: a 384-edge graph
    # on a loaded CPU may round to 0.
    assert d["unit"] == "Gnnz/s" and d["value"] >= 0
    assert d["vs_baseline"] > 0 and d["train_step_ms"] > 0
