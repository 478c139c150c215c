"""The standalone liftover CLI (`python -m telr_tpu_torch.liftover.cli`, the
reference's TELR_liftover.py run on its own) against the JAX package's
`telr_tpu.liftover.cli`: lift a BED of TE intervals on genome 1 onto genome 2.

Genome 1 is the contigs a port run on tail_dataset assembled
(reads.telr.contig.fasta; a 12 kb genome with one 1.2 kb insertion of alpha
and a truncated reference copy of alpha at 1 kb), its BED the TE interval the
run's expanded JSON gives on each contig plus one made-up interval at a
contig's head (so only one flank exists); genome 2 is the dataset's
reference, and `-2` gives it the reference copy of alpha.  Three modes, each
with and without `-2`: the standalone defaults (flank gap and overlap 50, a
flank's hits only on the sequence of its contig's own name), `--telr_mode`
(a TELR contig name chrom_start_end names its reference sequence) and
`--different_contig_name` (hits on any sequence).  The three files the CLI
writes are held byte for byte.  Tolerance: none (bytes)."""

import json
import os

import pytest

FILES = ("liftover_report.json", "liftover_summary.json",
         "liftover_nonref.bed")
MODES = {"standalone": [], "telr_mode": ["--telr_mode"],
         "different_contig_name": ["--different_contig_name"]}
# tail_dataset's reference copy of alpha: its last 700 bases at 1 kb
REF_TE = ("chrS", 1000, 1700, "alpha", ".", "+")


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    from telr_tpu_torch.config import SVConfig, TELRConfig
    from telr_tpu_torch.pipeline import run_pipeline
    from telr_tpu_torch.tools.bench_pipeline import tail_dataset
    data = tmp_path_factory.mktemp("liftover_cli")
    (reads, ref, lib), _truth = tail_dataset(str(data))
    out = data / "run"
    run_pipeline(reads, ref, lib, str(out),
                 TELRConfig(sv=SVConfig(min_support=3), threads=1),
                 device="cpu")
    with open(out / "reads.telr.expanded.json") as f:
        calls = json.load(f)
    rows = [(c["contig_id"], c["contig_te_start"], c["contig_te_end"],
             c["family"], ".", c["strand"]) for c in calls]
    assert rows, "the run assembled no TE contig"
    rows.append((rows[0][0], 0, 300, "beta", ".", "-"))
    bed1, bed2 = data / "genome1_te.bed", data / "genome2_te.bed"
    bed1.write_text("".join("\t".join(map(str, r)) + "\n" for r in rows))
    bed2.write_text("\t".join(map(str, REF_TE)) + "\n")
    return (str(out / "reads.telr.contig.fasta"), ref, str(bed1), str(bed2),
            data)


@pytest.fixture(scope="module", params=[(m, b) for m in MODES
                                        for b in (False, True)],
                ids=lambda p: p[0] + ("-bed2" if p[1] else ""))
def lifted(request, genomes):
    from telr_tpu.liftover import cli as jax_cli
    from telr_tpu_torch.liftover import cli
    fasta1, fasta2, bed1, bed2, data = genomes
    mode, with_bed2 = request.param
    argv = ["--fasta1", fasta1, "--fasta2", fasta2, "-1", bed1] + \
        MODES[mode] + (["-2", bed2] if with_bed2 else [])
    outs = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        outs[name] = str(data / f"{name}_{mode}_{int(with_bed2)}")
        main(argv + ["-o", outs[name]])
    return mode, with_bed2, outs


@pytest.mark.parametrize("name", FILES)
def test_liftover_cli_files_byte_identical(lifted, name):
    _mode, _b, outs = lifted
    with open(os.path.join(outs["port"], name), "rb") as f:
        got = f.read()
    with open(os.path.join(outs["jax"], name), "rb") as f:
        assert got == f.read()


def test_liftover_cli_reads_each_option(lifted):
    """The insertion lifts with both flanks where its contig's name need not
    be a reference sequence's (`--telr_mode`, `--different_contig_name`),
    and then `-2` gives its distance to the reference copy of alpha."""
    mode, with_bed2, outs = lifted
    with open(os.path.join(outs["port"], "liftover_report.json")) as f:
        insertion = json.load(f)[0]["report"]
    both_flanks = insertion["comment"].startswith("overlap/gap size")
    assert both_flanks == (mode != "standalone")
    assert (insertion["distance_5p_flank_ref_te"] is not None) == \
        (both_flanks and with_bed2)
