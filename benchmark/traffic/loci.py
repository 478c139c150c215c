"""Traffic `loci`: the per-locus half of a sample, pass after pass.

Set-up runs what run_pipeline runs before assembly, with its arguments:
stage 1, detect_insertions, filter_te_candidates and merge_nearby_records,
collect_extra_voters, and the reference's repeatmask_reference.  Its results
are cached beside the sample (loci_state.<device>.pkl).  A pass's time
follows its slowest locus (the POA rounds are lockstep and stop early when
no contig changes), so samples of one make differ in time by half from seed
to seed; a cell therefore fixes its sample (traffic_params.sample_seed).
The loci go to assemble_all in the order run_pipeline gives them
(merge_nearby_records'), as the same work for every seed: the POA pool
takes them in that order, so another order is another schedule, and a
pass's time moves with it.  A pass is
run_pipeline's four stage calls over every candidate locus in one batch:
assemble_all -> annotate_contigs + reannotate_families -> estimate_af ->
liftover.  The rate is candidate loci carried through a second.

The judge holds the last pass's calls to the planted insertions (a call is
a non-reference liftover entry; it matches an insertion within +-100 bp with
the family right, as tools/genome_eval.py scores), each number over the
sample's planted insertions:
  missed         share of the planted insertions with no matching call
  false_calls    calls that match no planted insertion
  te_off         matched calls whose TE (the contig's TE interval, either
                 strand) lies further than the cell's te_call_gap from the
                 planted TE, in edit distance over the planted TE's length;
                 the planted TE may keep or leave out at most the TSD's
                 length of reference on either side (refdp, `free` ends):
                 the consensus's accuracy and the TE's boundaries together
  te_gap         the widest of those distances (read by calibrate.py; not
                 checked: one locus of few carrying reads sets it, PERF.md)
  tsd_off        share of the matched calls whose TSD length is not the
                 planted one
  af_rule_off    matched calls whose allele frequency, or its absence, is
                 not what TELR's rule makes of the call's own reported
                 depths (_telr_af; exact: 0)
  af_missing     matched calls with no allele frequency (TELR gives none
                 where its two strands' estimates differ by more than 0.3)
  af_off         matched calls whose allele frequency lies nearer the other
                 zygosity's (1 hom, 0.5 het: across 0.75) than their own
A window holds one pass (a pass takes longer than the window), so no two
passes of one run are compared.
The control breaks the guarantee that a contig is the consensus of its
locus's reads: the vote and the POA rounds hand the backbone read back
unchanged, so each contig is one raw read.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List

import numpy as np

from benchmark import inputs, port, refdp

RATE = "loci_per_s"
WINDOW = 100
MAX_RATIO, MAX_TAF_DIFF = 1.5, 0.3      # TELR_te.py:570, :819


def _telr_af(depths: dict):
    """TELR's allele frequency from a call's depths: each strand's TE over
    flank depth at the TE's 5' end (dropped above MAX_RATIO), their mean
    where they differ by MAX_TAF_DIFF or less and none where more, the one
    there is where the other is missing; capped at 1."""
    def ratio(te, flank):
        if not te or not flank:
            return None
        r = te / flank
        return None if r > MAX_RATIO else r
    a = ratio(depths.get("te_5p_cov"), depths.get("flank_5p_cov"))
    b = ratio(depths.get("te_5p_cov_rc"), depths.get("flank_5p_cov_rc"))
    if a and b:
        f = (a + b) / 2 if abs(a - b) <= MAX_TAF_DIFF else None
    else:
        f = a or b
    return None if f is None else min(f, 1.0)


def _af_rule_off(depths: dict) -> bool:
    f, want = depths.get("freq"), _telr_af(depths)
    if f is None or want is None:
        return (f is None) != (want is None)
    return abs(float(f) - want) > 0.0005 + 1e-9     # rounded to 3 digits


def _planted(sample, t) -> np.ndarray:
    """Planted insertion t as its haplotype carries it, with its TSD on
    both sides: the reference's TSD bases, the TE, the TSD's copy."""
    tsd = sample.genome[t["pos"] - t["tsd"]:t["pos"]]
    return np.concatenate([tsd, t["te"], tsd])


def _derive(run, tcfg, reference, library, reads):
    """run_pipeline's stages before assembly, on the program."""
    from telr_tpu_torch.annotate.repeatmask import repeatmask_reference
    from telr_tpu_torch.assembly.local import collect_extra_voters
    from telr_tpu_torch.core.alignstore import AlignmentStore
    from telr_tpu_torch.sv.detect import detect_insertions
    from telr_tpu_torch.sv.filter import filter_te_candidates
    from telr_tpu_torch.sv.merge import merge_nearby_records
    from telr_tpu_torch.utils.evallog import LociEval
    aligner = port.stage1_aligner(reference, tcfg, run.device)
    try:
        res = aligner.map_batch_parallel({s.name: s.codes for s in reads},
                                         tcfg.threads)
    finally:
        port.close_aligner(aligner)
    store = AlignmentStore([a for hits in res.values() for a in hits])
    records = detect_insertions(store, reads, tcfg.sv, "reads")
    records = filter_te_candidates(
        records, library, LociEval(),
        use_wavefront=tcfg.wavefront_for("te_filter"), device=run.device)
    records = merge_nearby_records(records, tcfg.sv.merge_window)
    voters = collect_extra_voters(records, store, tcfg.assembly.window)
    ref_te = repeatmask_reference(
        reference, library, use_wavefront=tcfg.wavefront_for("repeatmask"),
        device=run.device)
    return {"store": store, "records": records, "voters": voters,
            "ref_te": ref_te if len(ref_te) else None}


def setup(run) -> dict:
    tcfg = port.telr_config(run.config, run.device)
    reference, library, reads = port.seqdicts(run.sample)
    path = os.path.join(inputs.seed_dir(run.config["name"], run.sample_seed),
                        f"loci_state.{run.device.type}.pkl")
    if os.path.isfile(path):
        with open(path, "rb") as f:      # written by this benchmark below
            derived = pickle.load(f)
    else:
        derived = _derive(run, tcfg, reference, library, reads)
        inputs.save_atomic(path, lambda f: pickle.dump(
            derived, f, protocol=pickle.HIGHEST_PROTOCOL))
    return {"tcfg": tcfg, "reference": reference, "library": library,
            "reads": reads, **derived}


def one_pass(run, st, records=None):
    from telr_tpu_torch.af.freq import estimate_af
    from telr_tpu_torch.annotate.contig import (annotate_contigs,
                                                reannotate_families)
    from telr_tpu_torch.assembly.local import assemble_all
    from telr_tpu_torch.liftover.engine import liftover
    from telr_tpu_torch.utils.evallog import LociEval
    tcfg, dev = st["tcfg"], run.device
    records = st["records"] if records is None else records
    loci_eval = LociEval()
    with run.spans.span("assembly"):
        contigs, passed = assemble_all(
            records, st["reads"], tcfg.read_preset, tcfg.assembly, loci_eval,
            use_wavefront=tcfg.wavefront_for("assembly"),
            extra_voters=st["voters"], device=dev)
    with run.spans.span("tail.annotate"):
        contig_te, te_seqs = annotate_contigs(
            contigs, passed, st["library"], records, tcfg.read_preset,
            tcfg.annotate, loci_eval,
            use_wavefront=tcfg.wavefront_for("annotate"), device=dev)
        if not tcfg.minimap2_family:
            contig_te = reannotate_families(
                contig_te, te_seqs, st["library"],
                use_wavefront=tcfg.wavefront_for("annotate"), device=dev)
    with run.spans.span("tail.af"):
        te_freq = estimate_af(
            records, contigs, contig_te, st["reads"], st["store"],
            tcfg.read_preset, tcfg.af, tcfg.assembly,
            use_wavefront=tcfg.wavefront_for("af"), device=dev)
    with run.spans.span("tail.liftover"):
        lift, _, _ = liftover(
            contigs, st["reference"], contig_te, st["ref_te"], tcfg.liftover,
            different_contig_name=tcfg.different_contig_name,
            telr_mode=True, use_wavefront=tcfg.wavefront_for("liftover"),
            device=dev)
    out = {"contigs": {s.name: s.codes for s in contigs},
           "te_freq": te_freq, "lift": lift, "n_records": len(records)}
    return len(records), len(records), out


def warm(run, st) -> None:
    """The locus with the fewest reads through the four stages: loads the
    kernels and the host engine and starts the vote's device path (the
    CUDA kernels build once, not per shape)."""
    if st["records"]:
        one_pass(run, st, [min(st["records"], key=lambda r: len(r.reads))])


def trace_hooks(run, st, patches) -> None:
    from telr_tpu_torch.assembly import device_vote
    from telr_tpu_torch.io import native
    from telr_tpu_torch.kernels import hopper_wavefront
    patches.wrap(native, "poa_consensus", run.spans, "assembly.poa")
    patches.wrap(device_vote, "vote_many", run.spans, "assembly.vote")
    patches.wrap(hopper_wavefront, "prepare_wavefront_batch", run.spans,
                 "assembly.wave_prep", before=run.launch_spy)


def close(run, st) -> None:
    for k in ("store", "reads", "reference"):
        st.pop(k, None)


def missing(run, out) -> int:
    """Candidate loci that came out of the last pass with no contig."""
    return out["n_records"] - len(out["contigs"])


def kept(run, out) -> dict:
    """The part of a pass's answers the judge reads: all of it."""
    return out


def _calls(out) -> List[dict]:
    calls = []
    for item in out["lift"]:
        info = item.get("report")
        if not info or info.get("type") != "non-reference":
            continue
        cid, _, coord = item["genome1_coord"].rpartition(":")
        cs, ce = (int(x) for x in coord.split("-"))
        calls.append({"chrom": info["chrom"], "start": int(info["start"]),
                      "end": int(info["end"]),
                      "families": str(info["family"]).split("|"),
                      "tsd": info.get("TSD_length"), "contig": cid,
                      "te_start": cs, "te_end": ce})
    return calls


def judge(run, st, outs) -> Dict[str, float]:
    truth = run.sample.truth
    out = outs[-1]
    calls = _calls(out)
    used, matched = set(), []
    for t in truth:
        for ci, c in enumerate(calls):
            if ci in used or c["chrom"] != t["chrom"]:
                continue
            if (c["start"] - WINDOW <= t["pos"] <= c["end"] + WINDOW
                    and t["family"] in c["families"]):
                used.add(ci)
                matched.append((t, c))
                break
    pairs, free = [], []
    for t, c in matched:
        te = out["contigs"][c["contig"]][c["te_start"]:c["te_end"]]
        planted = _planted(run.sample, t)
        pairs += [(te, planted), (refdp.revcomp(te), planted)]
        free += [(t["tsd"], t["tsd"])] * 2
    dist = refdp.edit_distance(pairs, free=free, device=run.ref_device)
    gaps = [min(dist[2 * i], dist[2 * i + 1]) / t["len"]
            for i, (t, _) in enumerate(matched)]
    off = float(run.cell["traffic_params"]["te_call_gap"])
    depths = [out["te_freq"].get(c["contig"]) or {} for _, c in matched]
    afs = [(d.get("freq"), t["zygosity"])
           for d, (t, _) in zip(depths, matched)]
    return {
        "missed": (len(truth) - len(matched)) / len(truth),
        "false_calls": len(calls) - len(matched),
        "te_off": sum(1 for g in gaps if g > off),
        "te_gap": max(gaps, default=0.0),
        "tsd_off": (sum(1 for t, c in matched if c["tsd"] != t["tsd"])
                    / max(1, len(matched))),
        "af_rule_off": sum(1 for d in depths if _af_rule_off(d)),
        "af_missing": sum(1 for f, _ in afs if f is None),
        "af_off": sum(1 for f, z in afs if f is not None
                      and (float(f) >= 0.75) != (z == "hom")),
    }


def control(run, st, outs) -> Dict[str, float]:
    """A pass with the vote and the POA rounds handing the backbone back."""
    from telr_tpu_torch.assembly import device_vote
    from telr_tpu_torch.io import native
    vote, has_poa = device_vote.vote_many, native.has_poa
    device_vote.vote_many = lambda items, device=None: [bb for bb, _ in items]
    native.has_poa = lambda: False
    try:
        _, _, out = one_pass(run, st)
    finally:
        device_vote.vote_many, native.has_poa = vote, has_poa
    run.control_out = out
    return judge(run, st, [out])


def _altered(last, what: str) -> dict:
    """The last pass's answers with one part of every call altered where
    it is produced: its site moved 1 kb ("site"), its TSD two bases longer
    ("tsd"), its allele frequency moved by 0.5 ("af") or left out
    ("af_none"), or 5% of its contig's bases substituted ("contig")."""
    out = dict(last)
    if what in ("site", "tsd"):
        lift = []
        for item in last["lift"]:
            info = item.get("report")
            if info and info.get("type") == "non-reference":
                if what == "site":
                    info = dict(info, start=info["start"] + 1000,
                                end=info["end"] + 1000)
                else:
                    info = dict(info,
                                TSD_length=(info.get("TSD_length") or 0) + 2)
                item = dict(item, report=info)
            lift.append(item)
        out["lift"] = lift
    elif what == "af":
        out["te_freq"] = {
            k: dict(v, freq=v["freq"] - 0.5 if v["freq"] >= 0.5
                    else v["freq"] + 0.5)
            if v and v.get("freq") is not None else v
            for k, v in last["te_freq"].items()}
    elif what == "af_none":
        out["te_freq"] = {k: dict(v or {}, freq=None)
                          for k, v in last["te_freq"].items()}
    else:
        rng = np.random.default_rng(0)
        out["contigs"] = {
            k: np.where(rng.random(len(c)) < 0.05, (c + 1) % 4,
                        c).astype(np.int8)
            for k, c in last["contigs"].items()}
    return out


def faults(run, st, outs) -> Dict[str, Dict[str, float]]:
    """The judge's numbers on the last pass's answers broken as the timed
    path could break them: half of the loci left out, and each part of
    every call altered where it is produced (_altered)."""
    last = outs[-1]
    keep = sorted(last["contigs"])[::2]
    half = dict(last, contigs={k: last["contigs"][k] for k in keep},
                lift=[i for i in last["lift"]
                      if i["genome1_coord"].rpartition(":")[0] in keep])
    res = {"half_batch": judge(run, st, [half])}
    for what in ("site", "tsd", "af", "af_none", "contig"):
        res[f"{what}_altered"] = judge(run, st, [_altered(last, what)])
    return res
