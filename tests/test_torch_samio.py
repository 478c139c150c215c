"""The port's SAM/BAM boundary (telr_tpu_torch/io/samio.py) held to the JAX
package's (the counterpart of tests/test_samio.py): parse_cigar on the same
strings, the bytes write_bam and write_sam give on the same store and reads,
and a file written by either package read back by either package (through
read_alignment_file, which dispatches on the extension) to the same store and
reads.  Two stores: reads mapped by the port's host engine on a random
reference (both strands, odd and even lengths), and a store made by hand with
a split read (two primary records, the lesser exported as supplementary), a
secondary record, a read with N bases and a record whose read is absent.
Tolerance: none (bytes, fields)."""

import dataclasses
import gzip
import struct

import numpy as np
import pytest

CIGARS = {
    "10M2I3M": [("M", 10), ("I", 2), ("M", 3)],
    "5=1X4=": [("M", 10)],
    "10M100N10M": [("M", 10), ("D", 100), ("M", 10)],
    "5S10M3H": [("M", 10)],
    "3H2S4M1D5M2P1I6S": [("M", 4), ("D", 1), ("M", 5), ("I", 1)],
    "5M2P5M3N2D": [("M", 10), ("D", 5)],
    "5M0I5M": [("M", 5), ("I", 0), ("M", 5)],
    "*": [],
    # not CIGARs: what the pattern finds in them
    "": [],
    "M10": [],
    "10M5": [("M", 10)],
    "10Q5M": [("M", 5)],
}

# what a read-back record keeps of the written one
KEPT = ("qname", "strand", "tname", "tstart", "tend", "cigar", "qstart",
        "qend", "qlen", "primary", "mapq")
FIELDS = ("qname", "qlen", "qstart", "qend", "strand", "tname", "tlen",
          "tstart", "tend", "matches", "blocklen", "mapq", "score", "cigar",
          "primary")
TLENS = {"chrA": 5000, "chrB": 3000, "chrC": 700}


@pytest.mark.parametrize("cigar", list(CIGARS))
def test_parse_cigar_as_the_reference(cigar):
    from telr_tpu.io.samio import parse_cigar as jax_parse
    from telr_tpu_torch.io.samio import parse_cigar
    assert parse_cigar(cigar) == jax_parse(cigar) == CIGARS[cigar]


def _mapped(rng):
    """Reads cut from a random reference (every other one reverse
    complemented, lengths 699-802) and their alignments by the port's host
    engine, as (reads {name: codes}, [Alignment fields])."""
    from telr_tpu_torch.config import MAP_PB
    from telr_tpu_torch.io.seqs import SeqDict, Sequence, revcomp_codes
    from telr_tpu_torch.kernels.mapper import Aligner
    ref = rng.integers(0, 4, TLENS["chrA"]).astype(np.int8)
    aligner = Aligner(SeqDict([Sequence("chrA", ref)]), MAP_PB, device="cpu")
    reads, rows = {}, []
    for i in range(5):
        s, n = 300 + i * 850, 699 + 26 * i
        codes = ref[s:s + n].copy()
        if i % 2:
            codes = revcomp_codes(codes)
        reads[f"r{i}"] = codes
        rows.extend(dataclasses.asdict(a)
                    for a in aligner.map_seq(f"r{i}", codes))
    return reads, rows


def _by_hand(rng):
    """A split read r1 (two primary records on two targets, the second
    scoring less), a secondary record of r2 (whose read holds N bases), a
    record of r3, which is not among the reads, and chrC, a target with no
    records."""
    reads = {"r0": rng.integers(0, 4, 801).astype(np.int8),
             "r1": rng.integers(0, 4, 999).astype(np.int8),
             "r2": rng.integers(0, 4, 600).astype(np.int8)}
    reads["r2"][[5, 6, 300]] = 4

    def row(qname, qlen, qs, qe, strand, tname, ts, cigar, primary=True,
            mapq=60, score=0):
        te = ts + sum(n for op, n in cigar if op in "MD")
        assert qe - qs == sum(n for op, n in cigar if op in "MI")
        return dict(qname=qname, qlen=qlen, qstart=qs, qend=qe,
                    strand=strand, tname=tname, tlen=TLENS[tname],
                    tstart=ts, tend=te, matches=score, blocklen=te - ts,
                    mapq=mapq, score=score, cigar=cigar, primary=primary)
    rows = [
        row("r0", 801, 0, 801, "+", "chrA", 100,
            [("M", 400), ("I", 1), ("M", 400)], score=790),
        row("r1", 999, 499, 999, "-", "chrA", 1000,
            [("M", 300), ("D", 5), ("M", 200)], score=480),
        row("r1", 999, 0, 450, "-", "chrB", 200, [("M", 450)], mapq=31,
            score=430),
        row("r2", 600, 0, 600, "+", "chrA", 2000, [("M", 600)], score=590),
        row("r2", 600, 2, 600, "+", "chrB", 1000,
            [("M", 300), ("I", 2), ("M", 296)], primary=False, mapq=0,
            score=500),
        row("r3", 320, 10, 310, "+", "chrB", 2500, [("M", 300)], score=290),
    ]
    return reads, rows


STORES = {"mapped": _mapped, "by_hand": _by_hand}


def _package(name):
    """The JAX package's or the port's (store and reads types, samio)."""
    if name == "jax":
        from telr_tpu.core.alignstore import AlignmentStore
        from telr_tpu.io import samio
        from telr_tpu.io.seqs import SeqDict, Sequence
        from telr_tpu.kernels.mapper import Alignment
    else:
        from telr_tpu_torch.core.alignstore import AlignmentStore
        from telr_tpu_torch.io import samio
        from telr_tpu_torch.io.seqs import SeqDict, Sequence
        from telr_tpu_torch.kernels.mapper import Alignment
    return AlignmentStore, Alignment, SeqDict, Sequence, samio


def _build(package, reads, rows):
    AlignmentStore, Alignment, SeqDict, Sequence, _ = _package(package)
    return (AlignmentStore([Alignment(**dict(r, cigar=list(r["cigar"])))
                            for r in rows]),
            SeqDict([Sequence(n, c.copy()) for n, c in reads.items()]))


@pytest.fixture(scope="module", params=list(STORES))
def store_case(request):
    reads, rows = STORES[request.param](np.random.default_rng(3))
    return request.param, reads, rows


def _write(package, fmt, reads, rows, path):
    store, seqs = _build(package, reads, rows)
    samio = _package(package)[4]
    writer = samio.write_bam if fmt == "bam" else samio.write_sam
    writer(store, seqs, str(path), tlens=TLENS)


def _rows(store):
    return [tuple(tuple(map(tuple, getattr(a, f))) if f == "cigar"
                  else getattr(a, f) for f in FIELDS) for a in store.all()]


def _reads(seqs):
    return [(s.name, s.codes.tolist()) for s in seqs]


@pytest.mark.parametrize("fmt", ["bam", "sam"])
def test_written_bytes_equal_the_reference(store_case, fmt, tmp_path):
    _name, reads, rows = store_case
    for package in ("port", "jax"):
        _write(package, fmt, reads, rows, tmp_path / f"{package}.{fmt}")
    got = (tmp_path / f"port.{fmt}").read_bytes()
    assert got == (tmp_path / f"jax.{fmt}").read_bytes()
    if fmt == "bam":
        # BGZF: gzip members with the BC subfield, then the EOF block
        assert got[:4] == b"\x1f\x8b\x08\x04" and got[12:14] == b"BC"
        assert got.endswith(bytes.fromhex(
            "1f8b08040000000000ff0600424302001b0003000000000000000000"))


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("ext", ["bam", "sam", "sam.gz"])
def test_read_back_in_both_packages(store_case, writer, ext, tmp_path):
    name, reads, rows = store_case
    path = tmp_path / f"out.{ext}"
    _write(writer, ext.split(".")[0], reads, rows, tmp_path / "plain")
    if ext == "sam.gz":
        path.write_bytes(gzip.compress((tmp_path / "plain").read_bytes()))
    else:
        (tmp_path / "plain").rename(path)
    back = {p: _package(p)[4].read_alignment_file(str(path))
            for p in ("port", "jax")}
    (port_store, port_reads), (jax_store, jax_reads) = back["port"], \
        back["jax"]
    assert _rows(port_store) == _rows(jax_store)
    assert _reads(port_reads) == _reads(jax_reads)
    for tname, ln in TLENS.items():
        assert np.array_equal(port_store.coverage(tname, 0, ln),
                              jax_store.coverage(tname, 0, ln))
    # ... and both equal what was written, as far as SAM / BAM carry it
    want = sorted(tuple(tuple(map(tuple, r[f])) if f == "cigar" else r[f]
                        for f in KEPT) for r in rows)
    got = sorted(tuple(tuple(map(tuple, getattr(a, f))) if f == "cigar"
                       else getattr(a, f) for f in KEPT)
                 for a in port_store.all())
    assert got == want
    with_record = {r["qname"] for r in rows if r["qname"] in reads}
    assert sorted(port_reads.names()) == sorted(with_record)
    for s in port_reads:
        assert np.array_equal(s.codes, reads[s.name]), s.name
    if name == "by_hand" and ext == "bam":
        # the split read's lesser record went out as supplementary
        flags = _bam_flags(path)
        assert sorted(flags["r1"]) == [0x10, 0x10 | 0x800]
        assert sorted(flags["r2"]) == [0, 0x100]


def _bam_flags(path):
    """{read name: [flag of each record]} of a BAM file."""
    data = gzip.open(str(path), "rb").read()
    (l_text,) = struct.unpack_from("<i", data, 4)
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 8 + l_name
    flags = {}
    while off < len(data):
        (size,) = struct.unpack_from("<i", data, off)
        l_name = data[off + 12]
        (flag,) = struct.unpack_from("<H", data, off + 18)
        name = data[off + 36:off + 36 + l_name - 1].decode()
        flags.setdefault(name, []).append(flag)
        off += 4 + size
    return flags


# SAM records as aligners write them: an unmapped record, hard clips on a
# supplementary record, =/X and N operations, a secondary record without
# SEQ, a record without CIGAR, a header comment
_SEQ_S0 = "ACGTTGCA" * 6
_SEQ_S1 = "GATTACAGATTACA"
HAND_SAM = "".join("\t".join(r) + "\n" for r in [
    ["@HD", "VN:1.6", "SO:coordinate"],
    ["@SQ", "SN:chrA", "LN:5000"],
    ["@SQ", "SN:chrB", "LN:3000"],
    ["@CO", "made by hand"],
    ["u0", "4", "*", "0", "0", "*", "*", "0", "0", "ACGT", "*"],
    ["s0", "0", "chrA", "101", "60", "5S20M2I10M1D8M3S", "*", "0", "0",
     _SEQ_S0, "*"],
    ["s0", "2064", "chrB", "51", "17", "33H15M", "*", "0", "0",
     _SEQ_S0[:15], "*"],
    ["s1", "16", "chrA", "300", "60", "4M1N3=2X5M", "*", "0", "0", _SEQ_S1,
     "*"],
    ["s1", "272", "chrB", "900", "0", "14M", "*", "0", "0", "*", "*"],
    ["s2", "0", "chrA", "1", "60", "*", "*", "0", "0", "ACGT", "*"],
])


@pytest.mark.parametrize("ext", ["sam", "sam.gz"])
def test_records_by_hand_read_as_the_reference(ext, tmp_path):
    path = tmp_path / f"hand.{ext}"
    raw = HAND_SAM.encode()
    path.write_bytes(gzip.compress(raw) if ext == "sam.gz" else raw)
    back = {p: _package(p)[4].read_alignment_file(str(path))
            for p in ("port", "jax")}
    (store, seqs), (jax_store, jax_seqs) = back["port"], back["jax"]
    assert _rows(store) == _rows(jax_store)
    assert _reads(seqs) == _reads(jax_seqs)
    from telr_tpu_torch.io.seqs import decode, encode, revcomp_codes
    got = {(a.qname, a.tname): a for a in store.all()}
    assert sorted(got) == [("s0", "chrA"), ("s0", "chrB"), ("s1", "chrA"),
                           ("s1", "chrB")]
    s0, sup = got["s0", "chrA"], got["s0", "chrB"]
    assert (s0.qlen, s0.qstart, s0.qend, s0.tstart, s0.tend) == \
        (48, 5, 45, 100, 139)
    # the supplementary record is a primary segment; its hard clips count
    # in the read's length, and it gives no read (SEQ is the aligned part)
    assert (sup.primary, sup.strand, sup.qlen, sup.qstart, sup.qend) == \
        (True, "-", 48, 0, 15)
    assert got["s1", "chrA"].cigar == [("M", 4), ("D", 1), ("M", 10)]
    assert got["s1", "chrB"].primary is False
    assert seqs.names() == ["s0", "s1"]
    assert decode(seqs["s0"].codes) == _SEQ_S0
    assert np.array_equal(seqs["s1"].codes, revcomp_codes(encode(_SEQ_S1)))
