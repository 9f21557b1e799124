"""CLI: `python -m uncalled_tpu_torch <subcommand>`.

Mirrors the reference CLI surface (scripts/uncalled:333-350): index, map,
sim, realtime, pafstats. Arguments reuse the reference's flag names where
they exist; device engine knobs replace thread counts.  ``map``, ``sim``,
``realtime`` and ``dtw`` take ``--device`` (default ``cuda``): they run on
the CUDA card and raise without one unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
import time


def _add_engine_opts(p):
    p.add_argument("--batch-reads", type=int, default=64,
                   help="device read slots (replaces -t threads)")
    p.add_argument("--evt-block", type=int, default=32,
                   help="events per jitted device step")
    p.add_argument("--max-paths", type=int, default=10000,
                   help="path budget per read (reference max_paths)")
    p.add_argument("--seed-rows", type=int, default=512,
                   help="seed SA-row budget per event")
    p.add_argument("--clusters", type=int, default=2048,
                   help="seed-cluster table capacity")
    p.add_argument("--conf", type=str, default=None, help="TOML config file")
    p.add_argument("-p", "--idx-preset", type=str, default="default",
                   help="threshold preset name from the .uncl file")


def _add_device_opt(p):
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda or cpu); there is no fallback "
                        "to the CPU")


def _add_conf_args(p):
    """Reflect every Conf sub-struct field into --section-field flags
    (the reference generates its CLI from Conf the same way,
    uncalled/args.py:223-304); defaults shown are the Conf defaults."""
    import dataclasses

    from .config import Conf

    conf = Conf()
    g = p.add_argument_group("config overrides (--<section>-<field>)")
    for f in dataclasses.fields(Conf):
        sub = getattr(conf, f.name)
        if not dataclasses.is_dataclass(sub):
            continue
        for sf in dataclasses.fields(type(sub)):
            if not isinstance(sf.type, str) or sf.type not in (
                "int", "float", "str", "bool"
            ):
                continue
            flag = f"--{f.name.replace('_', '-')}-{sf.name.replace('_', '-')}"
            default = getattr(sub, sf.name)
            kw = dict(default=None, dest=f"conf__{f.name}__{sf.name}")
            if sf.type == "bool":
                kw["type"] = lambda s: s.lower() in ("1", "true", "yes")
            else:
                kw["type"] = {"int": int, "float": float, "str": str}[sf.type]
            g.add_argument(flag, help=f"[{default}]", **kw)


def _load_conf(args):
    from .config import Conf

    conf = Conf()
    if getattr(args, "conf", None):
        conf.load_toml(args.conf)
    if hasattr(args, "batch_reads"):
        conf.engine.batch_reads = args.batch_reads
        conf.engine.evt_block = args.evt_block
    # reflected --section-field overrides (highest precedence)
    for k, v in vars(args).items():
        if v is None or not k.startswith("conf__"):
            continue
        _, section, field = k.split("__", 2)
        setattr(getattr(conf, section), field, v)
    return conf


def index_cmd(args):
    import os

    from .index.build import build_index
    from .index.fmindex import load_index
    from .index.parameterize import build_uncl

    prefix = args.bwa_prefix or args.fasta_filename
    if os.path.exists(prefix + ".utidx.npz"):
        sys.stderr.write("Using previously built index.\n")
        fmi = load_index(prefix)
    else:
        sys.stderr.write(f"Building index for {args.fasta_filename}\n")
        fmi = build_index(args.fasta_filename)
        fmi.save(prefix)
    sys.stderr.write("Fitting threshold presets\n")
    out = build_uncl(
        fmi,
        prefix,
        probs=args.probs.split(",") if args.probs else None,
        speeds=args.speeds.split(",") if args.speeds else None,
    )
    sys.stderr.write(f"Wrote {out}\nDone\n")


def map_cmd(args):
    from .index.fmindex import load_index
    from .io.fast5 import iter_reads
    from .mapping.batch import BatchMapper
    from .mapping.thresholds import load_uncl
    from .poremodel import load_default

    conf = _load_conf(args)
    fmi = load_index(args.bwa_prefix)
    threshes = load_uncl(args.bwa_prefix + ".uncl", args.idx_preset)
    # CL is always --clusters (default 2048), as in the JAX CLI: it
    # overrides the pooled engine's genome-scaled cluster capacity
    bm = BatchMapper(
        fmi, load_default(), threshes, conf, emit_timing=True,
        device=args.device,
        P=args.max_paths, C=args.max_paths, R=args.seed_rows, CL=args.clusters,
    )
    read_filter = None
    if args.read_list:
        with open(args.read_list) as f:
            read_filter = {l.strip() for l in f if l.strip()}
    reads = iter_reads(
        args.fast5s, recursive=args.recursive, max_reads=args.max_reads,
        read_filter=read_filter,
    )
    if args.ord:
        from .mapping.ordered import map_ordered

        n = 0
        t0 = time.time()
        for paf in map_ordered(
            fmi, load_default(), threshes, list(reads), conf,
            P=args.max_paths, C=args.max_paths, R=args.seed_rows,
            CL=args.clusters, device=args.device,
        ):
            sys.stdout.write(paf.to_line() + "\n")
            n += 1
        sys.stderr.write(f"Mapped {n} reads in {time.time()-t0:.1f}s\n")
        return
    n = 0
    t0 = time.time()
    for paf in bm.map_reads(reads):
        sys.stdout.write(paf.to_line() + "\n")
        sys.stdout.flush()
        n += 1
    sys.stderr.write(f"Mapped {n} reads in {time.time()-t0:.1f}s\n")


def pafstats_cmd(args):
    from . import pafstats

    pafstats.run(
        args.infile, ref_paf=args.ref_paf, max_reads=args.max_reads,
        annotate=args.annotate,
    )


def dtw_cmd(args):
    """Ground-truth DTW scoring of reads against known reference regions
    (the reference's dtw_test binary, dtw_test.cpp:62-179): for each read
    with a truth alignment in --paf, events -> mask -> normalize -> DTW
    vs the region's k-mers; prints `read_id  mean_score  ms` and
    optionally dumps the per-read path (--out-prefix, print_path role).
    The DTW runs on the host; ``--device`` is resolved like the mapping
    commands' so that the CLI's device rule holds for every command that
    takes it."""
    from .device import resolve
    from .index.fmindex import load_index
    from .io.fast5 import iter_reads
    from .ops.dtw import align_read
    from .pafstats import parse_paf

    resolve(args.device)
    conf = _load_conf(args)
    fmi = load_index(args.bwa_prefix)
    truth = {}
    for p in parse_paf(args.paf):
        if p.is_mapped and p.qr_name not in truth:
            truth[p.qr_name] = p
    reads = iter_reads(args.fast5s, recursive=args.recursive,
                       max_reads=args.max_reads)
    for read in reads:
        t = truth.get(read.id)
        if t is None:
            continue
        sig = read.signal
        if len(sig) > 50000 * 10:  # dtw_test.cpp:155 skip, scaled to raw
            print(f"Skipping {read.id}", file=sys.stderr)
            continue
        t0 = time.time()
        aln, _ = align_read(
            sig, fmi, t.rf_name, t.rf_st, t.rf_en, t.is_fwd, conf
        )
        dt = (time.time() - t0) * 1000
        if args.out_prefix:
            with open(f"{args.out_prefix}{read.id}.txt", "w") as f:
                for qr, rf in aln.get_path():
                    f.write(f"{qr}\t{rf}\n")
        print(f"{read.id}\t{aln.mean_score():.4f}\t{dt:.0f}")


def sim_cmd(args):
    from .realtime.sim import run_sim

    run_sim(args)


def yield_cmd(args):
    if args.cov_fname:
        # BED-coverage mode (reference sim_scripts/est_bed_yield.py)
        from .realtime.yield_est import est_bed_yield

        est_bed_yield(
            args.uncalled_fname, args.cov_fname, args.seq_sum,
            sim_speed=args.sim_speed,
        )
        return
    if args.deplete == args.enrich:
        sys.stderr.write("specify exactly one of --deplete / --enrich\n")
        sys.exit(1)
    if not (args.minimap_fname and args.bwa_prefix):
        sys.stderr.write("genome mode needs -m/--minimap-fname and -x\n")
        sys.exit(1)
    from .realtime.yield_est import est_genome_yield

    est_genome_yield(
        args.uncalled_fname, args.seq_sum, args.minimap_fname,
        args.bwa_prefix, deplete=args.deplete, sim_speed=args.sim_speed,
    )


def mask_cmd(args):
    from . import masking

    if args.mode == "internal":
        masking.mask_internal(args.fasta_in, args.fasta_out, args.k, args.iters)
    else:
        masking.mask_external(args.fasta_in, args.fasta_out, args.min_len)


def list_ports_cmd(args):
    # the reference scrapes MinKNOW logs (scripts/uncalled:297-320); without
    # a MinKNOW installation there is nothing to list
    import glob
    import os

    log_dir = "/var/log/MinKNOW"
    if not os.path.isdir(log_dir):
        sys.stderr.write(
            f"no MinKNOW installation found ({log_dir} missing)\n"
        )
        sys.exit(1)
    for fn in sorted(glob.glob(os.path.join(log_dir, "mk_manager_svc*.log"))):
        with open(fn) as f:
            for line in f:
                if "jsonrpc port" in line or "grpc port" in line:
                    sys.stdout.write(line)


def realtime_cmd(args):
    from .realtime.client import run_realtime

    run_realtime(args)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="uncalled_tpu_torch",
        description="raw nanopore signal mapper "
        "(UNCALLED capabilities, PyTorch/CUDA engine)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("index", help="build FM index + threshold presets")
    p.add_argument("fasta_filename")
    p.add_argument("-o", "--bwa-prefix", default=None)
    p.add_argument("--probs", default=None,
                   help="comma-separated target probs for extra presets")
    p.add_argument("--speeds", default=None,
                   help="comma-separated target speeds for extra presets")
    p.set_defaults(fn=index_cmd)

    p = sub.add_parser("map", help="batch-map fast5 reads, PAF to stdout")
    p.add_argument("bwa_prefix")
    p.add_argument("fast5s", nargs="+",
                   help="fast5 files / dirs / list files / comma lists")
    p.add_argument("-r", "--recursive", action="store_true")
    p.add_argument("-n", "--max-reads", type=int, default=0)
    p.add_argument("-l", "--read-list", type=str, default=None)
    p.add_argument("--ord", action="store_true",
                   help="replay reads in realtime chunk order (MapPoolOrd)")
    _add_device_opt(p)
    _add_engine_opts(p)
    _add_conf_args(p)
    p.set_defaults(fn=map_cmd)

    p = sub.add_parser("pafstats", help="PAF accuracy/speed statistics")
    p.add_argument("infile")
    p.add_argument("-r", "--ref-paf", default=None)
    p.add_argument("-n", "--max-reads", type=int, default=None)
    p.add_argument("-a", "--annotate", action="store_true")
    p.set_defaults(fn=pafstats_cmd)

    p = sub.add_parser(
        "dtw", help="ground-truth DTW scoring (reference dtw_test binary)"
    )
    p.add_argument("bwa_prefix")
    p.add_argument("fast5s", nargs="+")
    p.add_argument("--paf", required=True,
                   help="truth alignments (e.g. minimap2 PAF)")
    p.add_argument("--out-prefix", default="",
                   help="dump per-read DTW paths to <prefix><read_id>.txt")
    p.add_argument("-r", "--recursive", action="store_true")
    p.add_argument("--max-reads", type=int, default=0)
    _add_device_opt(p)
    _add_conf_args(p)
    p.set_defaults(fn=dtw_cmd)

    p = sub.add_parser("sim", help="simulated ReadUntil run (device simulator)")
    p.add_argument("bwa_prefix")
    p.add_argument("fast5s", nargs="+")
    p.add_argument("-r", "--recursive", action="store_true")
    p.add_argument("--ctl-seqsum", default="")
    p.add_argument("--unc-seqsum", default="")
    p.add_argument("--unc-paf", default="")
    p.add_argument("--sim-speed", type=float, default=1.0)
    p.add_argument("--enrich", action="store_true")
    p.add_argument("--deplete", action="store_true")
    p.add_argument("--duration", type=float, default=0.0)
    p.add_argument("--even", action="store_true")
    p.add_argument("--odd", action="store_true")
    _add_device_opt(p)
    _add_engine_opts(p)
    _add_conf_args(p)
    p.set_defaults(fn=sim_cmd)

    p = sub.add_parser("mask", help="repeat-mask a reference fasta")
    p.add_argument("fasta_in")
    p.add_argument("fasta_out")
    p.add_argument("--mode", choices=["internal", "external"], default="internal")
    p.add_argument("-k", type=int, default=15, help="k-mer length (internal)")
    p.add_argument("--iters", type=int, default=20, help="iterations (internal)")
    p.add_argument("--min-len", type=int, default=100,
                   help="min exact-repeat length (external)")
    p.set_defaults(fn=mask_cmd)

    p = sub.add_parser(
        "yield",
        help="post-sim enrichment accounting (est_genome_yield / "
             "est_bed_yield with -c)",
    )
    p.add_argument("-u", "--uncalled-fname", required=True)
    p.add_argument("-s", "--seq-sum", required=True)
    p.add_argument("-m", "--minimap-fname", default="")
    p.add_argument("-x", "--bwa-prefix", default="")
    p.add_argument("-c", "--cov-fname", default="",
                   help="BED coverage file -> est_bed_yield mode")
    p.add_argument("--deplete", action="store_true")
    p.add_argument("--enrich", action="store_true")
    p.add_argument("-t", "--sim-speed", type=float, default=1.0)
    p.set_defaults(fn=yield_cmd)

    p = sub.add_parser("list-ports", help="list MinKNOW device ports")
    p.set_defaults(fn=list_ports_cmd)

    p = sub.add_parser("realtime", help="live ReadUntil via read_until API")
    p.add_argument("bwa_prefix")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--duration", type=float, default=0.0)
    p.add_argument("--enrich", action="store_true")
    p.add_argument("--deplete", action="store_true")
    p.add_argument("--even", action="store_true")
    p.add_argument("--odd", action="store_true")
    p.add_argument("--chunk-time", type=float, default=1.0)
    _add_device_opt(p)
    _add_engine_opts(p)
    _add_conf_args(p)
    p.set_defaults(fn=realtime_cmd)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
