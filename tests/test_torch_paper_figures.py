"""``benchmarks_torch/paper_figures.py``, ``roofline.py`` and ``run.py``
against the reference's.

Every figure of ``paper_figures.ALL`` runs with ``quick=True`` in both
packages (the port with ``device="cpu"``): Figures 11-18 and 20 must give
the reference's rows exactly, Figure 19's rows are timings and are held by
name.  Figures 19 and 20 draw ``os.urandom``, which is patched for each
side to one ``numpy.random.default_rng(0).bytes``, so both write the same
block stores.  ``roofline.py`` reads a dry-run JSON that carries both
packages' fields, and ``run.py`` prints the reference's CSV.
"""
import json
import os
import sys

import numpy as np
import pytest

from test_torch_bench_small import ROOT, load

REF = load(ROOT / "benchmarks" / "paper_figures.py")
PORT = load(ROOT / "benchmarks_torch" / "paper_figures.py")


def _seeded(fn, monkeypatch, **kw):
    monkeypatch.setattr(os, "urandom", np.random.default_rng(0).bytes)
    return fn(quick=True, **kw)


@pytest.mark.parametrize("index", range(len(REF.ALL)),
                         ids=[fn.__name__ for fn in REF.ALL])
def test_figure_matches_reference(index, monkeypatch):
    ref_fn, port_fn = REF.ALL[index], PORT.ALL[index]
    assert port_fn.__name__ == ref_fn.__name__
    want = _seeded(ref_fn, monkeypatch)
    got = _seeded(port_fn, monkeypatch, device="cpu")
    assert want
    if ref_fn.__name__ == "fig19_code_packages":  # timings: the rows by name
        assert [r[0] for r in got] == [r[0] for r in want]
        assert [r[2] for r in got] == [r[2] for r in want]
    else:
        assert got == want


def _dryrun_dir(tmp_path):
    """One cell of both packages' ``cells()``, on both meshes, with the
    reference's fields and the port's set to the same values."""
    from repro.configs import cells as ref_cells
    from repro_torch.configs import cells

    assert list(cells(include_skipped=True)) == list(ref_cells(include_skipped=True))
    arch, shape, _ = next(c for c in cells(include_skipped=True) if c[2] is None)
    for mesh, frac in (("single", 0.25), ("multi", 0.125)):
        d = {"roofline": {"compute_s": 1.5, "memory_s": 0.75, "collective_s": 0.0625,
                          "dominant": "compute", "roofline_fraction": frac,
                          "useful_flops_ratio": 0.875},
             "memory": {"peak_per_device_bytes": 3 << 30, "argument_size_in_bytes": 3 << 30},
             "compile_s": 2.5, "trace_s": 2.5, "n_devices": 256}
        (tmp_path / f"{arch}__{shape}__{mesh}.json").write_text(json.dumps(d))
    return str(tmp_path)


def test_roofline_matches_reference(tmp_path):
    ref = load(ROOT / "benchmarks" / "roofline.py")
    port = load(ROOT / "benchmarks_torch" / "roofline.py")
    outdir = _dryrun_dir(tmp_path)
    renamed = {"mem_gib": "arg_gib", "compile_s": "trace_s"}
    for mesh in ("single", "multi"):
        want = ref.table_rows(outdir, mesh)
        got = port.table_rows(outdir, mesh)
        assert [r for r in want if "skip" not in r]  # the cell was read
        assert got == [{renamed.get(k, k): v for k, v in r.items()} for r in want]
        want_md = ref.markdown_table(outdir, mesh).splitlines()
        got_md = port.markdown_table(outdir, mesh).splitlines()
        assert got_md[1:] == want_md[1:]
        assert got_md[0] == want_md[0].replace("peak GiB/dev", "args GiB/dev")
    assert port.csv_rows(outdir) == ref.csv_rows(outdir) != []


def _rows(out: str) -> list[str]:
    """The CSV lines outside the timings (``_timing/`` and Figure 19)."""
    return [line for line in out.splitlines() if not line.startswith(("_timing/", "fig19/"))]


def test_run_prints_the_reference_csv(tmp_path, capsys, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    outdir = _dryrun_dir(tmp_path)
    ref = load(ROOT / "benchmarks" / "run.py")
    port = load(ROOT / "benchmarks_torch" / "run.py")
    for only in ("fig1", "roofline"):  # fig1 matches fig11 ... fig19
        args = ["--quick", "--only", only, "--dryrun-dir", outdir]
        monkeypatch.setattr(sys, "argv", ["run", *args])
        ref.main()
        want = _rows(capsys.readouterr().out)
        port.main([*args, "--device", "cpu"])
        assert _rows(capsys.readouterr().out) == want
        assert len(want) > (30 if only == "fig1" else 1)
