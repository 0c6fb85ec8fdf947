"""Command-line entry points.

Mirrors the reference's user-facing binaries:
  muscato               — full pipeline driver (cmd/muscato/main.go)
  muscato_prep_targets  — target DB preparation (cmd/muscato_prep_targets)
  muscato_gendat        — synthetic benchmark data (cmd/muscato_gendat)

The ten other stage binaries of the reference are internal pipeline stages
here (muscato_tpu.engine); they have no standalone CLI because the engine is
a single process over device arrays.
"""

from __future__ import annotations

import argparse
import sys


def main_prep_targets(argv=None) -> int:
    p = argparse.ArgumentParser(prog="muscato_prep_targets")
    p.add_argument("-rev", "--rev", action="store_true", help="Include reverse complement sequences")
    p.add_argument("genefile", nargs=1)
    ns = p.parse_args(argv)

    from muscato_tpu.io import targets

    seq_path, ids_path = targets.prep_targets(ns.genefile[0], rev=ns.rev)
    sys.stderr.write(f"Gene sequence file: {seq_path}\n")
    sys.stderr.write(f"Gene ids file: {ids_path}\n")
    return 0


def main_muscato(argv=None) -> int:
    from muscato_tpu import config as config_mod
    from muscato_tpu.engine import driver

    cfg = config_mod.parse_cli(argv)
    config_mod.apply_defaults(cfg)
    driver.run(cfg)
    return 0


def main_gendat(argv=None) -> int:
    p = argparse.ArgumentParser(prog="muscato_gendat")
    p.add_argument("-NumRead", "--NumRead", type=int, default=10000)
    p.add_argument("-ReadLen", "--ReadLen", type=int, default=100)
    p.add_argument("-NumGene", "--NumGene", type=int, default=10000)
    p.add_argument("-GeneLen", "--GeneLen", type=int, default=1000)
    p.add_argument("-Dir", "--Dir", type=str, default=".")
    p.add_argument("-Seed", "--Seed", type=int, default=0)
    ns = p.parse_args(argv)

    from muscato_tpu.bench import gendat

    gendat.generate(
        num_read=ns.NumRead,
        read_len=ns.ReadLen,
        num_gene=ns.NumGene,
        gene_len=ns.GeneLen,
        out_dir=ns.Dir,
        seed=ns.Seed,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main_muscato())
