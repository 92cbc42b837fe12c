#!/usr/bin/env python
"""Classify WHY the reference decoder misses bursts in the CFO soak.

The r4 soak measured ours 1536/1536 vs the reference 1523/1536 on
identical samples (tools/soak_compare.py --scenario cfo); VERDICT r4 #7
asks for the 13 misses to be EXPLAINED, not asserted away.  This tool
replays the exact soak stimulus (same seed/rng order, truth recorded),
runs ONLY the compiled reference (tests/refshim, unmodified sources —
no accelerator needed), and classifies every miss by controlled re-test:

  isolated     the burst ALONE in a fresh capture, same impairments:
               if the reference decodes it, the miss needs context —
               go to the pairwise test;
  pairwise     the burst plus its channel predecessor: if the second
               burst now fails, the miss is a serial-decoder
               interaction (sync search suspended while busy /
               stale frozen phase ring, d8psk.c:292-313);
  cfo=0        isolated retry without the carrier offset: decodes ->
               the reference's CFO estimator range is the cause;
  amp=1        isolated retry at full level: decodes -> u8
               quantization of the level spread is the cause;
  timing=0     isolated retry on integer timing: decodes -> fractional
               timing estimator;
  noise        isolated retry with a different noise seed: decodes ->
               the miss is a marginal SNR coin flip, not structural;
  multi-factor none of the single knobs alone recovers it.

Writes a JSON report and a per-class summary for PARITY.md.
"""
import sys

sys.path.insert(0, ".")
import argparse
import json
import subprocess

import numpy as np

from vdlm2dec_tpu import modulator as mod, framegen as fg
from vdlm2dec_tpu.io.sdr import write_capture

sys.path.insert(0, "tools")
from soak_compare import synth  # noqa: E402

REF = "/root/repo/tests/refshim/ref_shim"
TWO_PI = 2 * np.pi


def run_ref(path: str, fc: int, freqs: list[int]) -> list[dict]:
    cmd = ([REF, path, str(fc)] + [f"{f / 1e6:.6f}" for f in freqs]
           + ["-J"])
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=1800)
    return [json.loads(l) for l in r.stdout.splitlines()
            if l.strip().startswith("{")]


def make_single(rec: dict, fc: int, freqs: list[int], extra: dict,
                noise_seed: int = 7, with_prev: dict | None = None,
                path: str = "/tmp/miss_one.cu8") -> str:
    """Fresh SHORT capture containing just this burst (optionally
    preceded by its channel predecessor at the original relative gap).
    Positions are shifted down to ~1 s of warm-up — the reference's
    per-channel state (phase ring, AGC-free chain) warms in
    milliseconds, so absolute position is irrelevant and a 2 s capture
    re-tests a miss ~15x faster than replaying its in-soak offset."""
    fs = 2_000_000
    recs = ([with_prev] if with_prev else []) + [rec]
    base = min(r2["pos"] for r2 in recs) - 84_000
    seconds = (max(r2["pos"] + r2["len"] for r2 in recs) - base) \
        // 84_000 + 2
    total = fs * seconds
    total_bb = 84_000 * seconds
    wide = np.zeros(total, dtype=np.complex128)
    for r2 in recs:
        imp = {k: r2[k] for k in
               ("cfo_hz", "phase0", "timing_frac", "amplitude")}
        imp.update({k: v for k, v in extra.items() if r2 is rec})
        content = fg.acars_frame(
            text=r2["text"], label="Q0",
            from_addr=fg.AIRCRAFT | (0x100000 + r2["ci"] * 4096
                                     + (r2["pos"] & 0xFFF)))
        bb = np.zeros(total_bb, dtype=np.complex128)
        burst = mod.synthesize_baseband(mod.make_burst([content]),
                                        start=0, **imp)
        p = r2["pos"] - base
        bb[p: p + len(burst)] += burst
        wide += mod.upsample_to_wideband(bb, fs, r2["freq"] - fc,
                                         total=total)
    wide *= 40.0
    nrng = np.random.default_rng(noise_seed)
    wide += nrng.normal(size=total) + 1j * nrng.normal(size=total)
    write_capture(path, wide.astype(np.complex64), "cu8")
    return path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=int, default=30)
    ap.add_argument("--channels", type=int, default=8)
    ap.add_argument("--json", default="/tmp/ref_miss_report.json")
    args = ap.parse_args()

    rng = np.random.default_rng(42)
    fs, fc = 2_000_000, 136_775_000
    freqs = [136_600_000 + 50_000 * i for i in range(args.channels)]
    path = "/tmp/soak_cfo_miss.cu8"
    tpath = f"{path}.truth.json"
    import os
    if os.path.exists(path) and os.path.exists(tpath):
        with open(tpath) as f:
            saved = json.load(f)
        truth, n_tx = saved["truth"], saved["n_tx"]
        print("# capture cached", file=sys.stderr)
    else:
        truth = []
        wide, n_tx = synth("cfo", fs, fc, freqs, args.seconds, rng,
                           impair_ppm=2.0, spread_db=12.0, truth=truth)
        wide *= 40.0
        wide += (rng.normal(size=len(wide))
                 + 1j * rng.normal(size=len(wide)))
        write_capture(path, wide, "cu8")
        with open(tpath, "w") as f:
            json.dump({"truth": truth, "n_tx": n_tx}, f)
    print(f"# capture: {args.seconds}s x {len(freqs)}ch, {n_tx} bursts",
          file=sys.stderr)

    ref = run_ref(path, fc, freqs)
    got = {(r["freq"], r.get("text")) for r in ref}
    misses = [t for t in truth
              if (t["freq"] / 1e6, t["text"]) not in got]
    print(f"# reference decoded {len(got)}/{n_tx}; analysing "
          f"{len(misses)} misses", file=sys.stderr)

    by_ci: dict[int, list[dict]] = {}
    for t in truth:
        by_ci.setdefault(t["ci"], []).append(t)

    report = []
    for m in misses:
        sibs = by_ci[m["ci"]]
        i = sibs.index(m)
        prev = sibs[i - 1] if i else None
        gap = m["pos"] - (prev["pos"] + prev["len"]) if prev else None
        rec = {"ci": m["ci"], "pos": m["pos"],
               "cfo_hz": round(m["cfo_hz"], 1),
               "level_db": round(20 * np.log10(m["amplitude"]), 1),
               "timing_frac": round(m["timing_frac"], 3),
               "gap_prev84": gap}

        def ok(extra, with_prev=None, seed=7):
            p = make_single(m, fc, freqs, extra, noise_seed=seed,
                            with_prev=with_prev)
            return any(r.get("text") == m["text"]
                       for r in run_ref(p, fc, freqs))

        if ok({}):
            rec["isolated"] = "decodes"
            if prev is not None and not ok({}, with_prev=prev):
                rec["class"] = "interaction"  # busy/stale-ring w/ prev
            else:
                # decodes alone AND with its predecessor: localize the
                # poisoning context by running the reference on BYTE
                # SLICES of the actual capture — walk the fragment start
                # back until the miss reappears.  The poisoning onset
                # length tells the class: the reference's serial decoder
                # suspends sync search for the whole span a garbage
                # header claims (up to 8x255 bytes = ~131k samples), so
                # a miss that needs >20k samples of history is a junk-
                # trigger GETDATA span, not a neighbour-burst effect.
                rec["class"] = "context"
                onset = None
                margin = (m["len"] + 4000)
                for delta in (5_000, 20_000, 60_000, 140_000, 300_000):
                    s0 = max(0, (m["pos"] - delta) * 500 // 21
                             // 2000 * 2000)
                    s1 = (m["pos"] + margin) * 500 // 21
                    frag = np.fromfile(path, np.uint8)[2 * s0: 2 * s1]
                    frag.tofile("/tmp/miss_frag.cu8")
                    hit = any(r.get("text") == m["text"]
                              for r in run_ref("/tmp/miss_frag.cu8",
                                               fc, freqs))
                    if not hit:
                        onset = delta
                        break
                rec["poison_within84"] = onset
                if onset is not None:
                    # reproduced from capture bytes: a span-occupying
                    # event inside [pos-onset, pos) suppressed this
                    # burst's sync (the serial decoder's suspended
                    # search).  Count real bursts inside the poison
                    # window: 0 -> a junk trigger on pure noise; >0 ->
                    # the junk trigger rides a real burst's tail (the
                    # clean pairwise synth above still decoded, so the
                    # burst itself is not the poison).
                    inside = [t2 for t2 in sibs
                              if m["pos"] - onset <= t2["pos"] < m["pos"]]
                    rec["poison_contains_bursts"] = len(inside)
                    rec["class"] = "suspended-sync-span"
        elif ok({"cfo_hz": 0.0}):
            rec["class"] = "cfo"
        elif ok({"amplitude": 1.0}):
            rec["class"] = "level"
        elif ok({"timing_frac": 0.0}):
            rec["class"] = "timing"
        elif ok({}, seed=8):
            rec["class"] = "marginal-snr"
        else:
            rec["class"] = "multi-factor"
        report.append(rec)
        print(f"# miss ci={rec['ci']} pos={rec['pos']} "
              f"cfo={rec['cfo_hz']}Hz level={rec['level_db']}dB "
              f"gap={gap} -> {rec['class']}", file=sys.stderr)

    counts: dict[str, int] = {}
    for r in report:
        counts[r["class"]] = counts.get(r["class"], 0) + 1
    out = {"tx": n_tx, "ref_decoded": len(got), "misses": len(misses),
           "classes": counts, "detail": report}
    with open(args.json, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"classes": counts, "misses": len(misses),
                      "report": args.json}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
