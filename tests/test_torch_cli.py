"""The port's command line (``python -m uncalled_tpu_torch``) against the JAX
package's (``python -m uncalled_tpu``), both called in-process through
``main(argv)`` on the CPU (the port with ``--device cpu``): the parsers,
``index``, ``map`` on golden-derived fast5 reads (with reflected
``--<section>-<field>`` overrides; ``map --ord`` is in
tests/test_torch_cli_sim.py), ``pafstats``, ``mask``,
``yield``, ``dtw`` and ``list-ports``.  Outputs must be byte-identical;
PAF lines once the wall-clock tags (mt, qt, wt) are stripped, and the
``dtw`` lines without their milliseconds column."""

import argparse
import json
import os
import re
import shutil

import h5py
import numpy as np
import pytest
import torch

# both maskers bind sys.stderr as their log's default when first imported:
# import them here, where the stream is the session's, not a test's capture
import uncalled_tpu.masking  # noqa: F401
import uncalled_tpu_torch.masking  # noqa: F401
from test_yield_est import bed_inputs  # noqa: F401
from uncalled_tpu.__main__ import main as jmain
from uncalled_tpu_torch.__main__ import main as tmain

# one intra-op thread: the suite runs several pytest workers side by side,
# and spinning torch thread pools in each of them starve one another
torch.set_num_threads(1)

FX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
PREFIX = os.path.join(FX, "example_index", "example_ref")
_WALL = re.compile(r"\t(mt|qt|wt):f:[^\t]*")
# six golden reads that decide, on two channels
CLI_READS = ("sim_0000_Escherichia_coli_3854_+",
             "sim_0001_Escherichia_coli_3623_-",
             "sim_0002_Escherichia_coli_6254_+",
             "sim_0003_Escherichia_coli_6188_-",
             "sim_0004_Escherichia_coli_5013_+",
             "sim_0005_Escherichia_coli_3483_+")


def strip(line: str) -> str:
    """A PAF line without its wall-clock timing tags."""
    return _WALL.sub("", line)


def write_golden_fast5(path, rids, n_ch=2):
    """A multi-read fast5 of golden reads: each signal quantized to int16
    (digitisation 8192, range 1402, offset 0), dealt over ``n_ch``
    channels in turn, with start times and read numbers set."""
    sigs = np.load(os.path.join(FX, "golden_reads.npz"))
    with h5py.File(path, "w") as f:
        for i, rid in enumerate(rids):
            raw = np.clip(np.rint(sigs[rid] * (8192.0 / 1402.0)), -32768,
                          32767).astype(np.int16)
            g = f.create_group(f"read_{rid}")
            g.create_group("Raw").create_dataset("Signal", data=raw)
            g["Raw"].attrs.update(read_id=rid, read_number=i + 1,
                                  start_time=4000 * (i // n_ch) + 1)
            g.create_group("channel_id").attrs.update(
                channel_number=str(i % n_ch + 1), digitisation=8192.0,
                range=1402.0, offset=0.0)


def run(main, argv, capsys):
    """stdout and stderr of one in-process CLI call."""
    main(list(argv))
    out = capsys.readouterr()
    return out.out, out.err


def both(argv, capsys, device=True):
    """(port, JAX) stdout of the same command; the port on the CPU."""
    got, _ = run(tmain, list(argv) + (["--device", "cpu"] if device else []),
                 capsys)
    want, _ = run(jmain, argv, capsys)
    return got, want


@pytest.fixture(scope="module")
def golden_fast5(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "golden.fast5"
    write_golden_fast5(str(path), CLI_READS)
    return str(path)


class _Parser(Exception):
    pass


def _subcommands(main, monkeypatch):
    """{subcommand: {dest: what the action takes}} of main's parser."""
    def grab(self, *a, **k):
        raise _Parser(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parser) as e:
            main([])
    ap = e.value.args[0]
    sub, = [a for a in ap._actions
            if isinstance(a, argparse._SubParsersAction)]
    return {name: {a.dest: (tuple(a.option_strings), a.default, a.nargs,
                            a.required, a.choices, a.help,
                            getattr(a.type, "__name__", a.type))
                   for a in p._actions}
            for name, p in sub.choices.items()}


def test_parsers_have_the_same_subcommands_and_destinations(monkeypatch):
    got = _subcommands(tmain, monkeypatch)
    want = _subcommands(jmain, monkeypatch)
    assert list(got) == list(want) == [
        "index", "map", "pafstats", "dtw", "sim", "mask", "yield",
        "list-ports", "realtime"]
    for cmd in want:
        dev = got[cmd].pop("device", None)
        assert (dev is not None) == (cmd in ("map", "sim", "realtime",
                                             "dtw")), cmd
        if dev is not None:
            assert dev[:2] == (("--device",), "cuda")
        assert got[cmd] == want[cmd], cmd


def test_help_lists_every_subcommand(capsys):
    for main in (tmain, jmain):
        with pytest.raises(SystemExit) as e:
            main(["--help"])
        assert e.value.code == 0
        out = capsys.readouterr().out
        for cmd in ("index", "map", "pafstats", "dtw", "sim", "mask",
                    "yield", "list-ports", "realtime"):
            assert cmd in out


def test_index_writes_the_same_files(tmp_path, capsys):
    files = {}
    for tag, main in (("port", tmain), ("jax", jmain)):
        d = tmp_path / tag
        d.mkdir()
        fa = shutil.copy(PREFIX + ".fa", d / "ref.fa")
        _, err = run(main, ["index", str(fa), "-o", str(d / "ref")], capsys)
        assert "Building index" in err
        # a second run reuses the saved index and rewrites the presets
        _, err = run(main, ["index", str(fa), "-o", str(d / "ref"),
                            "--probs", "0.5,0.75", "--speeds", "450"],
                     capsys)
        assert "Using previously built index" in err
        with np.load(d / "ref.utidx.npz") as z:
            files[tag] = ((d / "ref.uncl").read_bytes(),
                          {k: z[k] for k in z.files})
    (uncl, arrs), (juncl, jarrs) = files["port"], files["jax"]
    assert uncl == juncl
    assert len(uncl.splitlines()) > 1
    assert sorted(arrs) == sorted(jarrs)
    for k in arrs:
        assert arrs[k].dtype == jarrs[k].dtype, k
        np.testing.assert_array_equal(arrs[k], jarrs[k])


def test_index_uncl_equals_the_in_repo_file(tmp_path, capsys):
    fa = shutil.copy(PREFIX + ".fa", tmp_path / "example_ref.fa")
    run(tmain, ["index", str(fa), "-o", str(tmp_path / "example_ref")],
        capsys)
    with open(PREFIX + ".uncl", "rb") as f:
        assert (tmp_path / "example_ref.uncl").read_bytes() == f.read()


@pytest.mark.parametrize("extra", [
    [],
    ["--engine-slot-handoff", "false", "--engine-drain-shrink", "0",
     "--batch-reads", "4", "--evt-block", "64", "-n", "5"],
], ids=["defaults", "overrides"])
def test_map_lines_equal_jax(golden_fast5, capsys, extra):
    got, want = both(["map", PREFIX, golden_fast5] + extra, capsys)
    got = [strip(x) for x in got.splitlines()]
    assert got == [strip(x) for x in want.splitlines()]
    assert len(got) == (5 if "-n" in extra else len(CLI_READS))
    assert sum("\t+\tEscherichia" in x or "\t-\tEscherichia" in x
               for x in got) == len(got)


def test_map_read_list_and_recursive(golden_fast5, tmp_path, capsys):
    d = tmp_path / "runs" / "deep"
    d.mkdir(parents=True)
    shutil.copy(golden_fast5, d / "a.fast5")
    lst = tmp_path / "reads.txt"
    lst.write_text(f"{CLI_READS[4]}\n\n{CLI_READS[1]}\n")
    got, want = both(["map", PREFIX, str(tmp_path / "runs"), "-r", "-l",
                      str(lst), "--batch-reads", "2"], capsys)
    got = [strip(x) for x in got.splitlines()]
    assert got == [strip(x) for x in want.splitlines()]
    assert sorted(x.split("\t")[0] for x in got) == sorted(
        [CLI_READS[1], CLI_READS[4]])


def test_pafstats_same_report(tmp_path, capsys):
    with open(os.path.join(FX, "golden_pafs.json")) as f:
        golden = json.load(f)
    ref = tmp_path / "ref.paf"
    ref.write_text("".join(golden[r] + "\n" for r in sorted(golden)))
    qry = tmp_path / "qry.paf"
    lines = [golden[r] for r in sorted(golden)]
    cols = lines[3].split("\t")
    cols[7], cols[8] = "100", "140"  # one read mapped to the wrong place
    lines[3] = "\t".join(cols)
    qry.write_text("".join(x + "\tmt:f:12.5\n" for x in lines))
    for argv in (["pafstats", str(qry)],
                 ["pafstats", str(qry), "-r", str(ref), "-a"],
                 ["pafstats", str(qry), "-r", str(ref), "-n", "5"]):
        got, want = both(argv, capsys, device=False)
        assert got == want and got


@pytest.mark.parametrize("argv", [["--mode", "internal", "-k", "8",
                                   "--iters", "3"],
                                  ["--mode", "external", "--min-len", "60"]],
                         ids=["internal", "external"])
def test_mask_same_file(tmp_path, capsys, argv):
    rng = np.random.default_rng(3)
    base = "".join("ACGT"[c] for c in rng.integers(0, 4, 2500))
    fa = tmp_path / "in.fa"
    fa.write_text(f">m\n{base[:800]}{'ACGTTGCA' * 25}{base[800:1600]}"
                  f"{base[200:500]}{base[1600:]}\n")
    outs = []
    for tag, main in (("port", tmain), ("jax", jmain)):
        run(main, ["mask", str(fa), str(tmp_path / f"{tag}.fa")] + argv,
            capsys)
        outs.append((tmp_path / f"{tag}.fa").read_bytes())
    assert outs[0] == outs[1]
    assert outs[0].count(b"N") >= 190


def test_yield_same_report(bed_inputs, tmp_path, capsys):  # noqa: F811
    paf, bed, seqsum = bed_inputs
    (tmp_path / "idx.ann").write_text("10000 1 11\n0 ref\n0 10000 0\n")
    mm2 = tmp_path / "truth.paf"
    mm2.write_text(
        "read_0\t2000\t0\t2000\t+\tref\t10000\t0\t2000\t2000\t2000\t60\n"
        "read_1\t3000\t0\t3000\t+\tref\t10000\t0\t3000\t3000\t3000\t60\n"
        "read_2\t1500\t0\t1500\t+\tother\t9000\t0\t1500\t1500\t1500\t60\n")
    base = ["yield", "-u", paf, "-s", seqsum]
    for argv in (base + ["-c", bed, "-t", "0.5"],
                 base + ["-m", str(mm2), "-x", str(tmp_path / "idx"),
                         "--enrich", "-t", "0.5"],
                 base + ["-m", str(mm2), "-x", str(tmp_path / "idx"),
                         "--deplete"]):
        got, want = both(argv, capsys, device=False)
        assert got == want and got
    for argv in (base + ["--deplete", "--enrich"], base + ["--enrich"]):
        errs = []
        for main in (tmain, jmain):
            with pytest.raises(SystemExit) as e:
                main(argv)
            errs.append((e.value.code, capsys.readouterr().err))
        assert errs[0] == errs[1] and errs[0][0] == 1


def test_dtw_same_scores_and_paths(golden_fast5, tmp_path, capsys):
    with open(os.path.join(FX, "golden_pafs.json")) as f:
        golden = json.load(f)
    truth = tmp_path / "truth.paf"
    truth.write_text("".join(golden[r] + "\n" for r in CLI_READS[1:4]))
    outs = []
    for tag, main, dev in (("port", tmain, ["--device", "cpu"]),
                           ("jax", jmain, [])):
        out, _ = run(main, ["dtw", PREFIX, golden_fast5, "--paf",
                            str(truth), "--out-prefix",
                            str(tmp_path / f"{tag}_")] + dev, capsys)
        lines = [x.rsplit("\t", 1)[0] for x in out.splitlines()]
        paths = {r: (tmp_path / f"{tag}_{r}.txt").read_bytes()
                 for r in CLI_READS[1:4]}
        outs.append((lines, paths))
    assert outs[0] == outs[1]
    assert [x.split("\t")[0] for x in outs[0][0]] == list(CLI_READS[1:4])


def test_list_ports_without_minknow(capsys):
    errs = []
    for main in (tmain, jmain):
        with pytest.raises(SystemExit) as e:
            main(["list-ports"])
        errs.append((e.value.code, capsys.readouterr()))
    assert errs[0] == errs[1]
    assert errs[0][0] == 1 and "no MinKNOW installation" in errs[0][1].err
