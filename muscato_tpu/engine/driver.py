"""Top-level run driver: the `muscato` entry point.

Mirrors the reference orchestrator's observable behavior
(/root/reference/cmd/muscato/main.go:930-979, 1005-1058):

  - a uuid run id names muscato_tmp/<uuid>/ and muscato_logs/<uuid>/
    (or <TempDir>/<uuid> when TempDir is configured);
  - the merged config is saved to LogDir/config.json;
  - per-stage log files and seqinfo.json (unique/total read counts,
    cmd/muscato_uniqify/main.go:144-161) land in LogDir;
  - stage artifacts (reads_sorted.txt.sz and the match arrays) are written
    to TempDir, giving per-stage resume granularity; TempDir is removed at
    exit unless NoCleanTemp.

Where the reference execs 12 stage binaries wired with pipes, this driver
calls the engine's stages in-process; the compute stages run on the JAX
default backend.
"""

from __future__ import annotations

import logging
import os
import shutil
import sys
import time
import uuid

import numpy as np

from ..config import Config
from ..io import reads as reads_io
from ..io import targets as targets_io
from . import pipeline, report


def make_run_dirs(cfg: Config) -> str:
    run_id = str(uuid.uuid1())
    if cfg.TempDir:
        cfg.TempDir = os.path.join(cfg.TempDir, run_id)
    else:
        cfg.TempDir = os.path.join("muscato_tmp", run_id)
    os.makedirs(cfg.TempDir, exist_ok=True)
    if not cfg.LogDir:
        cfg.LogDir = "muscato_logs"
    cfg.LogDir = os.path.join(cfg.LogDir, run_id)
    os.makedirs(cfg.LogDir, exist_ok=True)
    return run_id


def _setup_logging(cfg: Config) -> logging.Logger:
    """One log file per stage plus the top-level muscato.log, mirroring the
    reference's per-component files in muscato_logs/<uuid>/
    (cmd/muscato/main.go:699-706, cmd/muscato_screen/main.go:482-490,
    cmd/muscato_confirm/main.go:252-259)."""
    fmt = logging.Formatter("%(asctime)s %(name)s: %(message)s")

    def mk(name: str, filename: str, also=None) -> logging.Logger:
        lg = logging.getLogger(name)
        lg.setLevel(logging.INFO)
        lg.handlers.clear()
        lg.propagate = False
        fh = logging.FileHandler(os.path.join(cfg.LogDir, filename))
        fh.setFormatter(fmt)
        lg.addHandler(fh)
        if also is not None:
            lg.addHandler(also)
        return lg

    logger = mk("muscato", "muscato.log")
    main_fh = logger.handlers[0]
    mk("muscato.prep", "muscato_prep.log", also=main_fh)
    mk("muscato.index", "muscato_index.log", also=main_fh)
    # The pipeline logger is the screen+confirm equivalent: per-batch
    # heartbeats with candidate/survivor counts and throughput.
    mk("muscato.pipeline", "muscato_screen.log")
    mk("muscato.report", "muscato_report.log", also=main_fh)
    return logger


# Fixed, git-ignored cache directory inside the checkout: the directory
# is part of JAX's cache key, so it must not move between runs.
DEFAULT_COMPILE_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already uses it and this
    sets nothing.  Otherwise the cache goes to DEFAULT_COMPILE_CACHE."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE)
    return DEFAULT_COMPILE_CACHE


def require_device() -> None:
    """A CPU run happens only when asked for (JAX_PLATFORMS=cpu): where
    JAX finds no accelerator and the CPU was not asked for, the run stops
    instead of mapping on the CPU."""
    import jax

    if jax.devices()[0].platform == "cpu" and "cpu" not in (
        jax.config.jax_platforms or ""
    ).split(","):
        sys.stderr.write(
            "No accelerator found; set JAX_PLATFORMS=cpu to run on the CPU\n"
        )
        raise SystemExit(1)


def run(cfg: Config) -> None:
    for label, path in (
        ("ReadFileName", cfg.ReadFileName),
        ("GeneFileName", cfg.GeneFileName),
        ("GeneIdFileName", cfg.GeneIdFileName),
    ):
        if not os.path.exists(path):
            sys.stderr.write(f"Cannot open {label} {path}\n")
            raise SystemExit(1)
    require_device()
    enable_compile_cache()
    make_run_dirs(cfg)
    logger = _setup_logging(cfg)
    cfg.save(os.path.join(cfg.LogDir, "config.json"))

    try:
        _run_stages(cfg, logger)
    finally:
        if not cfg.NoCleanTemp:
            shutil.rmtree(cfg.TempDir, ignore_errors=True)


def _choose_mesh(cfg: Config, n_bases: int):
    """Pick the device mesh for this run, or None for the single-device
    engine.  'auto' (the default whenever several devices are visible)
    uses the fewest index shards that keep every shard under the int32
    position limit and spends the remaining devices on read parallelism."""
    import jax

    spec = (cfg.Mesh or "").strip().lower()
    if spec in ("off", "none", "single", "1x1"):
        return None
    ndev = len(jax.devices())
    if spec in ("", "auto"):
        if ndev <= 1:
            return None
        mp = 1
        while n_bases / mp > 1.5e9 and mp < ndev:
            mp *= 2
        dp = max(1, ndev // mp)
    else:
        try:
            dp_s, mp_s = spec.split("x")
            dp, mp = int(dp_s), int(mp_s)
        except ValueError:
            raise SystemExit(f"Mesh must be 'auto', 'off', or 'DPxMP'; got {cfg.Mesh!r}")
        if dp * mp == 1:
            return None
    from ..parallel import mesh as pmesh

    return pmesh.make_mesh(dp, mp)


def _build_or_load_index(cfg: Config, ts, logger):
    from .index import TargetIndex, build_target_index

    ilog = logging.getLogger("muscato.index")
    if cfg.IndexFile and os.path.exists(cfg.IndexFile):
        t0 = time.time()
        index = TargetIndex.load(cfg.IndexFile, ts, cfg.WindowWidth)
        ilog.info(
            "loaded index %s: %d window keys in %.2fs",
            cfg.IndexFile, index.num_valid, time.time() - t0,
        )
        return index
    t0 = time.time()
    index = build_target_index(ts, cfg.WindowWidth)
    ilog.info(
        "built index: %d bases -> %d window keys in %.2fs",
        index.num_bases, index.num_valid, time.time() - t0,
    )
    if cfg.IndexFile:
        index.save(cfg.IndexFile)
        ilog.info("saved index to %s", cfg.IndexFile)
    return index


def _run_stages(cfg: Config, logger: logging.Logger) -> None:
    t0 = time.time()
    plog = logging.getLogger("muscato.prep")
    rlog = logging.getLogger("muscato.report")

    if cfg.Coordinator or cfg.ProcessCount:
        # Multi-host runtime (no-op on single host runs without flags).
        from ..parallel import dist

        dist.initialize(
            coordinator_address=cfg.Coordinator or None,
            num_processes=cfg.ProcessCount or None,
            process_id=int(cfg.ProcessIndex) if cfg.ProcessIndex != "" else None,
        )
        logger.info("jax.distributed initialized (%s)", cfg.Coordinator)

    sys.stderr.write("Preparing reads...\n")
    ts_prep = time.time()
    import jax as _jax_prep

    if _jax_prep.process_count() > 1:
        # Range-sharded multi-host prep: each process parses only its byte
        # range of the read file and the per-host unique sets merge over
        # the process collective (parallel/dist.build_readset_multihost).
        from ..parallel import dist as _dist

        rs = _dist.build_readset_multihost(
            cfg.ReadFileName, cfg.MinReadLength, cfg.MaxReadLength
        )
    elif cfg.PrepChunk:
        # Bounded-memory prep: sorted unique runs spill to disk and
        # stream-merge into memmap-backed arrays (io.reads, the analogue
        # of the reference's external `sort -S 50%`).
        rs = reads_io.build_readset_chunked(
            cfg.ReadFileName, cfg.MinReadLength, cfg.MaxReadLength,
            chunk_reads=cfg.PrepChunk,
        )
    else:
        rs = reads_io.build_readset(
            cfg.ReadFileName, cfg.MinReadLength, cfg.MaxReadLength
        )
    plog.info(
        "prepared reads: %d total, %d unique in %.2fs",
        rs.num_total, rs.num_unique, time.time() - ts_prep,
    )
    with open(os.path.join(cfg.LogDir, "seqinfo.json"), "wt") as f:
        f.write('{"NumUnique":%d,"NumTotal":%d}\n' % (rs.num_unique, rs.num_total))
    reads_io.write_reads_sorted(rs, os.path.join(cfg.TempDir, "reads_sorted.txt.sz"))

    sys.stderr.write("Loading targets...\n")
    ts_tgt = time.time()
    ts = targets_io.load_targets(cfg.GeneFileName, cfg.GeneIdFileName)
    plog.info(
        "loaded %d target genes, %d bases in %.2fs",
        ts.num_genes, ts.size, time.time() - ts_tgt,
    )

    resume = os.path.join(cfg.ResumeDir, "matches.npz") if cfg.ResumeDir else ""
    if resume and os.path.exists(resume):
        # Stage-artifact resume: reuse a previous run's verified matches
        # (the reference's NoCleanTemp stage files give the same
        # granularity implicitly; see SURVEY.md section 5).
        sys.stderr.write(f"Resuming matches from {resume}...\n")
        d = np.load(resume)
        mr = pipeline.MatchResult(
            read_row=d["read_row"], gene=d["gene"],
            start=d["start"], nmiss=d["nmiss"],
        )
        logger.info("resumed %d matches from %s", len(mr.read_row), resume)
    else:
        sys.stderr.write("Screening and confirming...\n")

        def _match():
            mesh = _choose_mesh(cfg, ts.size)
            if mesh is not None:
                from ..parallel import mesh as pmesh

                logger.info(
                    "mesh run: dp=%d mp=%d", mesh.shape["dp"], mesh.shape["mp"]
                )
                sidx = pmesh.shard_targets(ts, cfg.WindowWidth, mesh.shape["mp"])
                return pmesh.run_matching_sharded(cfg, rs, sidx, mesh)
            index = _build_or_load_index(cfg, ts, logger)
            return pipeline.run_matching_indexed(cfg, rs, index)

        if cfg.CPUProfile:
            # The reference's --CPUProfile captures a pprof profile of the
            # screen (cmd/muscato_screen/main.go:530-538); here the
            # equivalent is a jax profiler trace of the matching stage.
            import jax

            with jax.profiler.trace(os.path.join(cfg.LogDir, "trace")):
                mr = _match()
            logger.info("profiler trace written to %s", os.path.join(cfg.LogDir, "trace"))
        else:
            mr = _match()
    import jax as _jax

    if _jax.process_count() > 1 and _jax.process_index() != 0:
        # Multi-host: retained rows are gathered to the primary and ranked
        # there (parallel/mesh.py); this process's MatchResult is empty by
        # construction, so there is no matches.npz stage artifact or
        # report output to write here (per-host temp/log dirs remain).
        logger.info("non-primary process: rank/report ran on the primary")
        return

    logger.info("retained %d matches", len(mr.read_row))
    np.savez(
        os.path.join(cfg.TempDir, "matches.npz"),
        read_row=mr.read_row, gene=mr.gene, start=mr.start, nmiss=mr.nmiss,
    )

    sys.stderr.write("Writing results...\n")
    rlog_t = time.time()
    table = report.write_results(cfg.ResultsFileName, mr, rs, ts)
    report.write_nonmatch(cfg.ResultsFileName, mr, rs)
    report.write_readstats(cfg.ResultsFileName, table)
    report.write_genestats(cfg.ResultsFileName, table)
    rlog.info(
        "wrote %d result rows (+nonmatch/readstats/genestats) in %.2fs",
        table.nrows, time.time() - rlog_t,
    )
    logger.info("done in %.2fs", time.time() - t0)
