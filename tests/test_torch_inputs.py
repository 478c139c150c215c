"""The reads inputs other than FASTA through both packages' CLIs: a
pre-aligned BAM, SAM and gzipped SAM (which skip the alignment stage, as the
reference's BAM path does, TELR_input.py:299-305), and FASTQ, plain and
gzipped.  `telr_tpu_torch.cli --device cpu` against `telr_tpu.cli` on the
host CPU, where both route every stage to the native host engine, on
small_dataset (a 12 kb genome, one 1.2 kb insertion, 4 kb reads at 8x, every
third reverse-complemented), one thread.

The alignment files hold the dataset's reads mapped once by the port's host
engine with the stage-1 preset (chain_prune_frac=0.5, as run_pipeline maps
them), so the port's BAM, SAM and FASTQ runs must also write its FASTA run's
files.  The dataset maps every read whole, so a second alignment input is
made by hand from the same records: two reads that carry the whole insertion
as one I operation (one of each strand) are split there into a primary and a
hard-clipped supplementary record, and a reverse-strand read gains a
secondary record without SEQ; it goes in as that SAM and as the BAM the
port's write_bam makes of it.

Every output file but the run's provenance and its timestamped log is held
byte for byte.  Tolerance: none (bytes)."""

import dataclasses
import gzip
import logging
import os
import re

import pytest

from telr_tpu_torch.tools.bench_pipeline import small_dataset
from test_torch_pipeline import OUTPUTS

# input file -> whether it is pre-aligned
INPUTS = {"reads.bam": True, "reads.sam": True, "reads.sam.gz": True,
          "reads.fq": False, "reads.fq.gz": False, "split.sam": True,
          "split.bam": True}
# inputs whose sample name ("reads") and records are the FASTA run's
AS_FASTA = ["reads.bam", "reads.sam", "reads.fq"]
PREALIGNED_LOG = "pre-aligned input provided, skip alignment step"


def outputs(path):
    """The nine files a run on `path` writes: run_pipeline names its sample
    after the file name less its last extension."""
    sample = os.path.splitext(os.path.basename(path))[0]
    return [sample + name[len("reads"):] if name.startswith("reads.")
            else name for name in OUTPUTS]


def _split(a, at):
    """Alignment `a` cut at its cigar's operation `at` (an I) into the
    primary alignments of the two flanks, in original read coordinates."""
    left, right = a.cigar[:at], a.cigar[at + 1:]
    ql = sum(n for op, n in left if op in "MI")
    qr = sum(n for op, n in right if op in "MI")
    rl = sum(n for op, n in left if op in "MD")
    if a.strand == "+":
        qspans = [(a.qstart, a.qstart + ql), (a.qend - qr, a.qend)]
    else:
        qspans = [(a.qend - ql, a.qend), (a.qstart, a.qstart + qr)]
    tspans = [(a.tstart, a.tstart + rl), (a.tstart + rl, a.tend)]
    return [dataclasses.replace(a, qstart=qs, qend=qe, tstart=ts, tend=te,
                                cigar=ops)
            for (qs, qe), (ts, te), ops in zip(qspans, tspans,
                                               (left, right))]


def write_split_sam(store, reads, tlens, path):
    """The store's records as SAM (the port's write_sam), with the insertion
    of a forward and a reverse read split in two, the right flank's record
    supplementary (flag 0x800) with hard clips and its aligned SEQ only, and
    a secondary record (flag 0x100, SEQ *) for a third, reverse-strand read,
    7 bases right of its primary.  Returns the flags written."""
    from telr_tpu_torch.core.alignstore import AlignmentStore
    from telr_tpu_torch.io.samio import write_sam
    alns, supplementary, secondary, split = [], set(), set(), set()
    for a in store.all():
        at = next((i for i, (op, n) in enumerate(a.cigar)
                   if op == "I" and n >= 1000), None)
        if at is not None and a.strand not in {s for _q, s in split}:
            left, right = _split(a, at)
            alns += [left, right]
            split.add((a.qname, a.strand))
            supplementary.add((a.qname, right.tstart))
        else:
            alns.append(a)
    assert {s for _q, s in split} == {"+", "-"}, "no read of each strand"
    other = next(a for a in alns if a.strand == "-" and a.qname not in
                 {q for q, _s in split} and a.tend + 7 <= tlens[a.tname])
    alns.append(dataclasses.replace(other, tstart=other.tstart + 7,
                                    tend=other.tend + 7, mapq=0,
                                    primary=False))
    secondary.add((other.qname, other.tstart + 7))
    plain = path + ".plain"
    write_sam(AlignmentStore(alns), reads, plain, tlens=tlens)
    flags = []
    with open(plain) as src, open(path, "w") as out:
        for line in src:
            e = line.rstrip("\n").split("\t")
            if not line.startswith("@"):
                key = (e[0], int(e[3]) - 1)
                if key in supplementary:
                    lead = re.match(r"(\d+)S", e[5])
                    tail = re.search(r"(\d+)S$", e[5])
                    lead = int(lead.group(1)) if lead else 0
                    tail = int(tail.group(1)) if tail else 0
                    e[1] = str(int(e[1]) | 0x800)
                    e[5] = e[5].replace("S", "H")
                    e[9] = e[9][lead:len(e[9]) - tail]
                elif key in secondary:
                    e[9] = "*"
                flags.append(int(e[1]))
            out.write("\t".join(e) + "\n")
    os.remove(plain)
    return flags


def write_fastq(reads, path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as out:
        for s in reads:
            out.write(f"@{s.name}\n{s.seq}\n+\n{'5' * len(s)}\n")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from telr_tpu_torch.config import TELRConfig
    from telr_tpu_torch.core.alignstore import AlignmentStore
    from telr_tpu_torch.io.fasta import read_fasta
    from telr_tpu_torch.io.samio import read_sam, write_bam, write_sam
    from telr_tpu_torch.kernels.mapper import Aligner
    data = tmp_path_factory.mktemp("inputs")
    (reads_fa, ref_fa, lib_fa), truth = small_dataset(str(data))
    reads, reference = read_fasta(reads_fa), read_fasta(ref_fa)
    tlens = reference.sizes()
    preset = dataclasses.replace(TELRConfig().read_preset,
                                 chain_prune_frac=0.5)
    hits = Aligner(reference, preset, device="cpu").map_batch_parallel(
        {s.name: s.codes for s in reads}, 1)
    store = AlignmentStore([a for h in hits.values() for a in h])
    path = {name: str(data / name) for name in INPUTS}
    write_bam(store, reads, path["reads.bam"], tlens=tlens)
    write_sam(store, reads, path["reads.sam"], tlens=tlens)
    with open(path["reads.sam"], "rb") as f:
        with gzip.open(path["reads.sam.gz"], "wb") as g:
            g.write(f.read())
    write_fastq(reads, path["reads.fq"])
    write_fastq(reads, path["reads.fq.gz"])
    flags = write_split_sam(store, reads, tlens, path["split.sam"])
    write_bam(*read_sam(path["split.sam"]), path["split.bam"], tlens=tlens)
    path["reads.fa"] = reads_fa
    return path, ref_fa, lib_fa, truth, flags


class _Lines(logging.Handler):
    """The messages both packages' pipelines log (logger "telr_tpu")."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def run_cli(package, reads, ref, lib, out, extra=()):
    """One run of `package`'s CLI (`extra`: more flags); returns its result
    and its log lines."""
    if package == "port":
        from telr_tpu_torch import cli
        device = ["--device", "cpu"]
    else:
        from telr_tpu import cli
        device = []
    log = logging.getLogger("telr_tpu")
    tap, level = _Lines(), log.level
    log.setLevel(logging.INFO)
    log.addHandler(tap)
    try:
        res = cli.main(["-i", reads, "-r", ref, "-l", lib, "-o", out,
                        "-t", "1", "--min_support", "3"] + device
                       + list(extra))
    finally:
        log.removeHandler(tap)
        log.setLevel(level)
    return res, tap.lines


@pytest.fixture(scope="module")
def run_of(dataset, tmp_path_factory):
    """run_of(package, input) -> (result, log lines, out dir) of that CLI
    run, made at its first call; input "reads.fa" is the FASTA reads."""
    path, ref, lib, _truth, _flags = dataset
    done = {}

    def run(package, name):
        if (package, name) not in done:
            out = str(tmp_path_factory.mktemp(f"{package}_{name}"))
            done[package, name] = run_cli(package, path[name], ref, lib,
                                          out) + (out,)
        return done[package, name]
    return run


def _same(a_dir, b_dir, f):
    with open(os.path.join(a_dir, f), "rb") as a, \
            open(os.path.join(b_dir, f), "rb") as b:
        return a.read() == b.read()


@pytest.mark.parametrize("k", range(len(OUTPUTS)), ids=OUTPUTS)
@pytest.mark.parametrize("name", list(INPUTS))
def test_input_output_byte_identical(run_of, name, k):
    f = outputs(name)[k]
    assert _same(run_of("port", name)[2], run_of("jax", name)[2], f), f


@pytest.mark.parametrize("name", list(INPUTS))
def test_input_calls_the_insertion(dataset, run_of, name):
    """Both packages call the one planted insertion; a pre-aligned input
    skips the alignment stage (and its throughput record), FASTQ does not."""
    (port, port_log, _), (want, jax_log, _) = (run_of("port", name),
                                               run_of("jax", name))
    assert port.final_report == want.final_report
    ((pos, fam),) = dataset[3]
    assert [(c["family"], abs(c["start"] - pos) < 200)
            for c in port.final_report] == [(fam, True)]
    for lines in (port_log, jax_log):
        assert (PREALIGNED_LOG in lines) == INPUTS[name]
        assert any(ln.startswith("alignment throughput")
                   for ln in lines) != INPUTS[name]


@pytest.mark.parametrize("k", range(len(OUTPUTS)), ids=OUTPUTS)
@pytest.mark.parametrize("name", AS_FASTA)
def test_run_equals_the_fasta_run(run_of, name, k):
    """The port's BAM, SAM and FASTQ runs write its FASTA run's files: the
    alignment files hold the FASTA run's stage 1."""
    f = OUTPUTS[k]
    assert _same(run_of("port", name)[2], run_of("port", "reads.fa")[2], f), f


@pytest.mark.parametrize("name", ["split.sam", "split.bam"])
def test_split_input_carries_every_record_kind(dataset, name):
    """The hand-made input holds reverse-strand, supplementary and secondary
    records (and split.sam hard clips and a secondary without SEQ)."""
    path, _ref, _lib, _truth, sam_flags = dataset
    if name == "split.sam":
        flags = sam_flags
        with open(path[name]) as f:
            recs = [ln.split("\t") for ln in f if not ln.startswith("@")]
        assert any("H" in r[5] and int(r[1]) & 0x800 for r in recs)
        assert any(r[9] == "*" and int(r[1]) & 0x100 for r in recs)
    else:
        from test_torch_samio import _bam_flags
        flags = [f for fs in _bam_flags(path[name]).values() for f in fs]
    for bit in (0x10, 0x100, 0x800):
        assert any(f & bit for f in flags), hex(bit)
    assert any(f & 0x10 and f & 0x800 for f in flags)
