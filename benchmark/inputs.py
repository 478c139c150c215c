"""A configuration's sample, made from the seed, and the cache it is kept in.

The genome, the TE library and the reads come from the frozen generators
(generators.py).  The insertions are planted by `plant_balanced`: every
seed gets the same insertions in kind (each family as often, once hom and
once het, the same TSD lengths and divergences), in another order at other
sites, so that a seed changes where the work lies and not how much of it
there is.  The planted truth and
each read's origin on the reference are kept beside the sample: they are
what the judges hold the program's answers to.

The cache is benchmark/.cache/<config>/<seed>/, at a fixed path inside the
checkout, written once per seed and atomically (a file appears whole or not
at all).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Tuple

import numpy as np

from benchmark import generators as gen

CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".cache")


@dataclasses.dataclass
class Sample:
    chrom: str
    genome: np.ndarray                 # int8 codes 0-3
    library: Dict[str, np.ndarray]
    reads: List[Tuple[str, np.ndarray]]
    truth: List[dict]                  # planted insertions, "te" oriented
    origin: np.ndarray                 # (n_reads, 2) reference interval

    @property
    def read_bases(self) -> int:
        return int(sum(len(c) for _, c in self.reads))


def plant_balanced(genome, library, n_ins, rng):
    """n_ins insertions in which every seed gets the same work: the
    library's families in turn, each family's copies alternately hom and
    het, TSDs of 4-12 bp and divergences of 0-5% spread evenly, all dealt
    in a seed-drawn order; one site drawn in each of n_ins equal bins of
    [50 kb, size - 50 kb], kept a quarter bin (at most 10 kb) from the
    bin's edges.  Each insertion is a diverged copy on a random strand, as
    plant_insertions makes them."""
    size = len(genome)
    fams = list(library)
    kinds = [(fams[k % len(fams)], "hom" if (k // len(fams)) % 2 == 0
              else "het") for k in range(n_ins)]
    tsds = np.rint(np.linspace(4, 12, n_ins)).astype(int)
    divs = np.linspace(0.0, 0.05, n_ins)
    order = [rng.permutation(n_ins) for _ in range(3)]
    lo, hi = 50_000, size - 50_000
    step = (hi - lo) / n_ins
    margin = int(min(10_000, step // 4))
    truth = []
    for k in range(n_ins):
        a = int(lo + k * step) + margin
        b = int(lo + (k + 1) * step) - margin
        pos = int(rng.integers(a, max(a + 1, b)))
        fam, zyg = kinds[order[0][k]]
        te = gen._diverge(library[fam], float(divs[order[1][k]]), rng)
        strand = "+"
        if rng.random() < 0.5:
            te = (3 - te)[::-1].copy()
            strand = "-"
        truth.append({"pos": pos, "family": fam, "strand": strand,
                      "tsd": int(tsds[order[2][k]]), "len": int(len(te)),
                      "zygosity": zyg, "te": te})
    return truth


def hap_to_ref(h: int, inserted: List[Tuple[int, int]]) -> int:
    """A haplotype coordinate on the reference: `inserted` holds (reference
    position, inserted length) of the haplotype's insertions in order; a
    base inside an insertion maps to its position."""
    off = 0
    for pos, extra in inserted:
        if h < pos + off:
            return h - off
        if h < pos + off + extra:
            return pos
        off += extra
    return h - off


def make(cfg: dict, seed: int) -> Sample:
    rng = np.random.default_rng(seed)
    library = gen.make_te_library(rng)
    genome = gen.make_genome(int(cfg["genome_size"]), library, rng)
    truth = plant_balanced(genome, library, int(cfg["n_insertions"]), rng)
    reads = gen.simulate_reads(genome, truth, int(cfg["coverage"]), rng,
                               read_len_mean=int(cfg["read_len_mean"]),
                               ont_profile=bool(cfg["ont_profile"]))
    haps = [[(t["pos"], t["len"] + t["tsd"]) for t in truth],
            [(t["pos"], t["len"] + t["tsd"]) for t in truth
             if t["zygosity"] == "hom"]]
    origin = np.array([(hap_to_ref(s, haps[h]), hap_to_ref(e - 1, haps[h]) + 1)
                       for h, s, e in gen.simulate_reads.last_sources],
                      np.int64)
    chrom = cfg.get("chrom", "chr2L")
    for t in truth:
        t["chrom"] = chrom
    return Sample(chrom, genome, library,
                  [(f"c0_{n}", c) for n, c in reads], truth, origin)


def _pack(seqs: List[np.ndarray]):
    lens = np.array([len(s) for s in seqs], np.int64)
    return (np.concatenate(seqs) if seqs else np.zeros(0, np.int8)), lens


def _unpack(flat, lens) -> List[np.ndarray]:
    ends = np.cumsum(lens)
    return [flat[e - n:e] for n, e in zip(lens, ends)]


def sample_seed(cell: dict, seed: int) -> int:
    """The seed a cell's sample is made from: the run's, or the fixed
    `sample_seed` of the cell's traffic parameters, where the cell's work
    would change too much from sample to sample."""
    return int(cell["traffic_params"].get("sample_seed", seed))


def seed_dir(cfg_name: str, seed: int) -> str:
    return os.path.join(CACHE, cfg_name, str(int(seed)))


def save_atomic(path: str, write) -> None:
    """write(f) into path + ".part", then rename: a reader never sees half
    a file."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".part"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, path)


def load_or_make(cfg: dict, seed: int) -> Sample:
    path = os.path.join(seed_dir(cfg["name"], seed), "sample.npz")
    if os.path.isfile(path):
        z = np.load(path, allow_pickle=False)
        meta = json.loads(str(z["meta"]))
        lib = dict(zip(meta["lib_names"], _unpack(z["lib"], z["lib_lens"])))
        reads = list(zip(meta["read_names"],
                         _unpack(z["reads"], z["read_lens"])))
        truth = meta["truth"]
        for t, te in zip(truth, _unpack(z["te"], z["te_lens"])):
            t["te"] = te
        return Sample(meta["chrom"], z["genome"], lib, reads, truth,
                      z["origin"])
    s = make(cfg, seed)
    lib, lib_lens = _pack(list(s.library.values()))
    rd, rd_lens = _pack([c for _, c in s.reads])
    te, te_lens = _pack([t["te"] for t in s.truth])
    meta = {"chrom": s.chrom, "lib_names": list(s.library),
            "read_names": [n for n, _ in s.reads],
            "truth": [{k: v for k, v in t.items() if k != "te"}
                      for t in s.truth]}
    save_atomic(path, lambda f: np.savez(
        f, meta=json.dumps(meta), genome=s.genome, lib=lib,
        lib_lens=lib_lens, reads=rd, read_lens=rd_lens, te=te,
        te_lens=te_lens, origin=s.origin))
    return s
