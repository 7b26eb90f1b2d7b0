#!/usr/bin/env python3
"""On-chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--out results.json]

Phases, in order (any failure raises and exits non-zero):

1. build the three CUDA kernels from ``src/repro_torch/kernels/csrc`` with
   nvcc (one process per source, in parallel) and print the build time;
2. hold each kernel equal to its plain PyTorch version on the card, on
   random inputs from a numpy seed: at the main path's shapes, at a ragged
   edge, and for ``match_bank_chunks`` in both its shared-memory and its
   global-memory branch at ``n_starts = n`` and ``n_starts = 1``; time each
   kernel, its plain version, and (where one exists) one PyTorch call that
   computes the same function;
3. drive the main path at full size with every launch count at 0: the
   bundled 23-signature PROSITE bank through ``Scanner.compile`` under the
   default plan (SFA budget 512: SFA and enumeration patterns) and under
   ``mode="sfa"`` with budget 20000 (all 23 SFAs, the largest 7,184
   states), each followed by ``scan`` and ``census`` of a 65,536 x 384
   random protein corpus; then read the launch counts;
4. run the same construction and scan through the plain versions on the
   card, and through the NumPy ``reference`` backend on a 256-document
   sub-corpus, and require equal SFAs, hits and census;
5. with ``--profile`` only: trace one compile and one scan per budget with
   ``torch.profiler`` and print where the device time goes.

It prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and as its last line ``{"ok": true, "device": {...}}``. It exits non-zero
without a result when no CUDA device is present or when the package is not
beside it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
DOCS, DOC_LEN = 65_536, 384          # 25.2 M residues
N_CHUNKS = 8
TILE, K = 128, 20                    # construction tile, amino-acid alphabet
REF_DOCS = 256                       # sub-corpus of the NumPy reference

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the int32 ALU
#: rate: 64 INT32 lanes per SM x 132 SMs x 1.98 GHz, a quarter of the
#: 67 TFLOP/s float32 rate (128 FP32 lanes, an FMA counting two).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.75e12

#: Integer operations per bit-sliced 32x32 carry-less multiply: 32 steps of
#: (mask from b's bit, shift a left, and-xor into lo, shift a right, and-xor
#: into hi).
CLMUL32_OPS = 32 * 5


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    check(out, "nvidia-smi printed no card")
    return out[0]


def cuda_ms(torch, fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after a warm-up,
    from CUDA events around the whole run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float) -> tuple:
    """(least time in ms, what bounds it) on the H100's peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# Phase 2: every kernel against its plain version
# --------------------------------------------------------------------------


def kernel_cases(torch, ops, ref, dev):
    rng = np.random.default_rng(SEED)

    def i32(a):
        return torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.uint64).astype(np.uint32)
            .view(np.int32)).to(dev)

    def ids(hi, shape):
        return torch.from_numpy(
            rng.integers(0, hi, shape).astype(np.int32)).to(dev)

    def u32(shape):
        return i32(rng.integers(0, 1 << 32, shape, dtype=np.uint64))

    cases = []

    # fingerprint_bank: the widest construction bucket's round (6 patterns
    # with n_max = 87: W = 44 words, T·k = 2560 candidates), then a ragged
    # edge (B not a multiple of the block, odd W).
    for label, (P, B, W) in (("main", (6, TILE * K, 44)),
                             ("ragged", (3, 1000, 7))):
        args = (u32((P, B, W)), u32((P, W, 2)), u32((P, 4)))
        rows = P * B
        cases.append(dict(
            kernel="fingerprint_bank", label=label,
            shape=f"words {P}x{B}x{W}",
            run=lambda a=args: ops.fingerprint_bank(*a),
            plain=lambda a=args: ref.fingerprint_bank(*a),
            library=None,
            nbytes=4 * (P * B * W + P * W * 2 + P * 4 + P * B * 2),
            # Per word two 32x32 products and 4 XORs into the limbs; the
            # Barrett step three products (its operands are one limb wide)
            # and 4 XORs.
            ops=rows * (W * (2 * CLMUL32_OPS + 4) + 3 * CLMUL32_OPS + 4),
        ))

    # expand_bank: the same bucket's frontier tile, then a ragged edge.
    for label, (B, T, n) in (("main", (6, TILE, 87)),
                             ("ragged", (3, 37, 13))):
        tables, ft = ids(n, (B, n, K)), ids(n, (B, T, n))
        tab_t = tables.transpose(1, 2).contiguous()          # (B, k, n)
        src = tab_t[:, None].expand(B, T, K, n)
        index = ft.to(torch.int64)[:, :, None].expand(B, T, K, n)
        cases.append(dict(
            kernel="expand_bank", label=label,
            shape=f"tables {B}x{n}x{K}, ft {B}x{T}x{n}",
            run=lambda a=(tables, ft): ops.expand_bank(*a),
            plain=lambda a=(tables, ft): ref.expand_bank(*a),
            # One PyTorch call computing the same function (a yardstick,
            # never used by the port): gather along the state axis.
            library=lambda s=src, i=index, sh=(B, T * K, n):
                torch.gather(s, 3, i).view(sh),
            nbytes=4 * (B * T * n + B * n * K + B * T * K * n),
            ops=0,
        ))

    # match_bank_chunks at the scan's shapes (65,536 docs x 8 chunks of 48
    # symbols): the SFA group (18 deltas of <= 272 rows, one lane) and the
    # enumeration group (5 tables of 87 states, all lanes) at budget 512 —
    # both in shared memory — and all 23 SFA deltas at budget 20000 (7,184
    # rows, global memory, one lane); then the global branch at n_starts = n
    # on fewer chunks, and a ragged edge.
    chunks = ids(K, (DOCS * N_CHUNKS, DOC_LEN // N_CHUNKS))
    few = chunks[:4096].contiguous()
    for label, (P, n, ch, ns) in (
            ("enumeration, budget 512 (smem)", (5, 87, chunks, 87)),
            ("sfa, budget 512 (smem)", (18, 272, chunks, 1)),
            ("sfa, budget 20000 (global)", (23, 7184, chunks, 1)),
            ("global branch, n_starts = n", (2, 7184, few, 7184)),
            ("ragged, smem, n_starts = n", (3, 13, ids(K, (1001, 7)), 13)),
            ("ragged, smem, n_starts = 1", (3, 13, ids(K, (1001, 7)), 1))):
        tables = ids(n, (P, n, K))
        B, L = ch.shape
        smem = n * K * 4 <= ops.MATCH_SMEM_TABLE_MAX
        check(smem == ("smem" in label), f"branch of case {label!r}")
        cases.append(dict(
            kernel="match_bank_chunks", label=label,
            shape=f"tables {P}x{n}x{K}, chunks {B}x{L}, n_starts {ns}",
            run=lambda a=(tables, ch, ns): ops.match_bank_chunks(*a),
            plain=lambda a=(tables, ch, ns): ref.match_bank_chunks(*a),
            library=None,
            nbytes=4 * (P * n * K + B * L + P * B * ns),
            ops=2 * P * B * ns * L,
        ))
    return cases


def check_expand_limit(torch, ops, dev) -> None:
    """``expand_bank`` stages each table in shared memory: a table larger
    than a block may hold must raise ValueError, without a launch."""
    n = 4096                          # 4096 x 20 x 4 B = 320 KB
    before = ops.launches["expand_bank"]
    try:
        ops.expand_bank(torch.zeros((1, n, K), dtype=torch.int32, device=dev),
                        torch.zeros((1, 1, n), dtype=torch.int32, device=dev))
    except ValueError as e:
        print(f"[kernel] expand_bank, {n}-state table: ValueError ({e})",
              flush=True)
    else:
        raise RuntimeError("check failed: expand_bank accepted a table "
                           "larger than a block's shared memory")
    check(ops.launches["expand_bank"] == before,
          "expand_bank launched on a table it cannot stage")


def run_kernel_checks(torch, ops, ref, dev) -> list:
    check_expand_limit(torch, ops, dev)
    results = []
    for c in kernel_cases(torch, ops, ref, dev):
        got = c["run"]()
        want = c["plain"]()
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{c['kernel']} {c['label']}: shape/dtype")
        err = int((got.to(torch.int64) - want.to(torch.int64))
                  .abs().max().item()) if got.numel() else 0
        check(err == 0, f"{c['kernel']} {c['label']}: differs from its "
                        f"plain version (max abs err {err})")
        ms = cuda_ms(torch, c["run"])
        plain_ms = cuda_ms(torch, c["plain"], reps=2)
        lib_ms = None
        if c["library"] is not None:
            check(torch.equal(c["library"](), want),
                  f"{c['kernel']} {c['label']}: library yardstick differs")
            lib_ms = cuda_ms(torch, c["library"])
        b_ms, b_by = bound(c["nbytes"], c["ops"])
        r = dict(kernel=c["kernel"], label=c["label"], shape=c["shape"],
                 max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                 bound_by=b_by, library_ms=lib_ms)
        print(f"[kernel] {c['kernel']:18s} {c['label']:32s} {c['shape']:44s}"
              f" equal  {ms:9.4f} ms  plain {plain_ms:9.3f} ms  bound "
              f"{b_ms:8.4f} ms ({b_by})"
              + (f"  library {lib_ms:8.4f} ms" if lib_ms is not None else ""),
              flush=True)
        results.append(r)
        del got, want
    return results


# --------------------------------------------------------------------------
# Phases 3 and 4: the main path, then plain and reference twins
# --------------------------------------------------------------------------


def sfa_sizes(scanner) -> dict:
    out = {}
    for g in scanner.groups:
        if g.mode == "sfa":
            for i, s in zip(g.indices, g.sfa_states):
                out[scanner.ids[i]] = int(s)
    return out


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main_path(torch, ops, corpus) -> dict:
    from repro_torch.core.prosite import load_bank
    from repro_torch.engine import Scanner

    bank = load_bank()
    runs = {}
    ops.reset_launches()
    for name, overrides in (("budget 512 (auto)", {}),
                            ("budget 20000 (sfa)",
                             dict(mode="sfa", sfa_state_budget=20_000))):
        sc, t_compile = timed(torch, lambda: Scanner.compile(bank, **overrides))
        res, t_scan = timed(torch, lambda: sc.scan(corpus))
        census, t_census = timed(torch, lambda: sc.census(corpus))
        check(np.array_equal(census, res.counts), f"{name}: census vs scan")
        rep = sc.construction_report
        sizes = sfa_sizes(sc)
        modes = list(sc.pattern_modes.values())
        runs[name] = dict(scanner=sc, hits=res.hits, census=census,
                          compile_s=t_compile, scan_s=t_scan,
                          census_s=t_census, rounds=rep.rounds,
                          blown=rep.blown, sfa_states=sizes,
                          n_sfa=modes.count("sfa"),
                          n_enum=modes.count("enumeration"))
        print(f"[main] {name}: compile {t_compile:.3f} s "
              f"({rep.rounds} construction rounds, {rep.blown} blown, "
              f"{modes.count('sfa')} sfa / {modes.count('enumeration')} "
              f"enumeration patterns); scan {t_scan:.3f} s "
              f"= {corpus.size / t_scan / 1e6:.1f} M residues/s; census "
              f"{t_census:.3f} s", flush=True)
        print(f"[main] {name}: SFA states {sizes}", flush=True)
        print(f"[main] {name}: census {census.tolist()}", flush=True)
    launches = dict(ops.launches)
    print(f"[main] kernel launches in the main path: {launches}", flush=True)

    r512, r20k = runs["budget 512 (auto)"], runs["budget 20000 (sfa)"]
    check(r512["blown"] == 5 and r512["n_sfa"] == 18 and r512["n_enum"] == 5,
          "budget 512 splits the bank 18 SFA / 5 enumeration")
    check(r20k["blown"] == 0 and r20k["n_sfa"] == 23,
          "all 23 SFAs close at budget 20000")
    check(max(r20k["sfa_states"].values()) == 7184,
          "largest SFA at budget 20000 has 7,184 states")
    for name, r in runs.items():
        check(r["hits"].shape == (23, DOCS), f"{name}: hit matrix shape")
    # The kernel cases above use these group shapes.
    g512 = {g.mode: g for g in r512["scanner"].groups}
    check(tuple(g512["enumeration"].tables.shape) == (5, 87, K)
          and tuple(g512["sfa"].deltas.shape) == (18, 272, K)
          and tuple(r20k["scanner"].groups[0].deltas.shape) == (23, 7184, K),
          "main-path table shapes match the kernel cases")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched by the main path")
    return dict(runs=runs, launches=launches)


def plain_hits(torch, X, kref, scanner, corpus) -> np.ndarray:
    """Hits of ``scanner``'s groups with the chunk walks through the plain
    version of the kernel, on the card."""
    hits = np.zeros((scanner.n_patterns, corpus.shape[0]), dtype=bool)
    head = torch.as_tensor(corpus, device=scanner.device)
    for g in scanner.groups:
        if g.mode == "sfa":
            maps = X.bank_doc_mappings_sfa(g.deltas, g.sfa_maps, head,
                                           N_CHUNKS,
                                           match_fn=kref.match_bank_chunks)
        else:
            maps = X.bank_doc_mappings(g.tables, head, N_CHUNKS,
                                       match_fn=kref.match_bank_chunks)
        hits[g.indices] = X.hits_of_mappings(
            maps, g.accepting, g.starts).cpu().numpy()
    return hits


def twins(torch, corpus, main) -> dict:
    from repro_torch.construction import construct_bank
    from repro_torch.core.prosite import load_bank
    from repro_torch.engine import ConstructionPolicy, Scanner
    from repro_torch.engine import executors as X
    from repro_torch.kernels import ref as kref

    bank = load_bank()
    out = {}
    for name, budget, overrides in (
            ("budget 512 (auto)", 512, {}),
            ("budget 20000 (sfa)", 20_000,
             dict(mode="sfa", sfa_state_budget=20_000))):
        kern, t_kern = timed(torch, lambda: construct_bank(
            bank, max_states=budget))
        plain, t_plain = timed(torch, lambda: construct_bank(
            bank, max_states=budget, fingerprint_backend="plain",
            expand_backend="plain"))
        check(np.array_equal(kern.blown, plain.blown)
              and np.array_equal(kern.stats.retries, plain.stats.retries),
              f"{name}: plain construction verdicts")
        for a, b in zip(kern.sfas, plain.sfas):
            check((a is None) == (b is None), f"{name}: blown sets")
            if a is not None:
                check(np.array_equal(a.delta, b.delta)
                      and np.array_equal(a.mappings, b.mappings)
                      and np.array_equal(a.fingerprints, b.fingerprints),
                      f"{name}: plain construction gives the same SFAs")
        policy = ConstructionPolicy(fingerprint_backend="plain",
                                    expand_backend="plain")
        sc_plain = Scanner.compile(bank, construction=policy, **overrides)
        hits_plain, t_pscan = timed(
            torch, lambda: plain_hits(torch, X, kref, sc_plain, corpus))
        kernel_hits = main["runs"][name]["hits"]
        check(np.array_equal(hits_plain, kernel_hits),
              f"{name}: plain scan hits equal the kernel scan's")
        sc_ref = Scanner.compile(bank, backend="reference", **overrides)
        sub = corpus[:REF_DOCS]
        ref_res, t_ref = timed(torch, lambda: sc_ref.scan(sub))
        check(np.array_equal(ref_res.hits, kernel_hits[:, :REF_DOCS])
              and np.array_equal(ref_res.counts,
                                 kernel_hits[:, :REF_DOCS].sum(1)),
              f"{name}: reference backend hits and census")
        out[name] = dict(construct_kernel_s=t_kern, construct_plain_s=t_plain,
                         rounds=kern.stats.rounds, scan_plain_s=t_pscan,
                         reference_s=t_ref)
        print(f"[twins] {name}: construct_bank kernel {t_kern:.3f} s / plain "
              f"{t_plain:.3f} s ({kern.stats.rounds} rounds, SFAs equal); "
              f"plain scan {t_pscan:.3f} s, hits equal; reference backend "
              f"{REF_DOCS} docs {t_ref:.3f} s, hits equal", flush=True)
    return out


def profile_main_path(torch, corpus) -> dict:
    """Device-time breakdown of one compile and one scan per budget (a
    separate traced run; the walls above are untraced)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.prosite import load_bank
    from repro_torch.engine import Scanner

    bank = load_bank()
    out = {}
    for name, overrides in (("budget 512 (auto)", {}),
                            ("budget 20000 (sfa)",
                             dict(mode="sfa", sfa_state_budget=20_000))):
        sc = Scanner.compile(bank, **overrides)
        for phase, fn in (("compile", lambda: Scanner.compile(bank,
                                                              **overrides)),
                          ("scan", lambda: sc.scan(corpus))):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            ka = prof.key_averages()
            kernels = sorted(
                (e for e in ka if e.device_type == DeviceType.CUDA),
                key=lambda e: -e.self_device_time_total)
            busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
            top = [dict(name=e.key[:90], calls=e.count,
                        device_ms=e.self_device_time_total / 1e3)
                   for e in kernels[:12]]
            out[f"{name} {phase}"] = dict(wall_s=wall, device_busy_ms=busy_ms,
                                          top=top)
            print(f"[profile] {name} {phase}: traced wall {wall * 1e3:.1f} ms,"
                  f" device busy {busy_ms:.1f} ms "
                  f"({busy_ms / (wall * 1e3):.1%})", flush=True)
            for t in top:
                print(f"[profile]   {t['device_ms']:9.3f} ms {t['calls']:6d}x"
                      f"  {t['name']}", flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the numbers to this JSON")
    parser.add_argument("--profile", action="store_true",
                        help="add a traced run: device time by kernel")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    try:
        from repro_torch.kernels import build, ops
        from repro_torch.kernels import ref as kref
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script "
              f"({e})", file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    logs = build.build_all()
    t_build = time.perf_counter() - t0
    print(f"[build] {len(logs)} kernel libraries built in {t_build:.2f} s "
          f"(nvcc for sm_90a, in parallel)", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    kernel_results = run_kernel_checks(torch, ops, kref, dev)

    corpus = np.random.default_rng(SEED).integers(
        0, K, (DOCS, DOC_LEN), dtype=np.int32)
    main_res = main_path(torch, ops, corpus)
    twin_res = twins(torch, corpus, main_res)
    prof_res = profile_main_path(torch, corpus) if args.profile else None

    sources = {
        "fingerprint_bank": ("src/repro_torch/kernels/csrc/fingerprint_bank.cu",
                             "src/repro/kernels/clmul.py:169"),
        "expand_bank": ("src/repro_torch/kernels/csrc/expand_bank.cu",
                        "src/repro/kernels/expand.py:64"),
        "match_bank_chunks": (
            "src/repro_torch/kernels/csrc/match_bank_chunks.cu",
            "src/repro/kernels/match_scan.py:116"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        rows = [r for r in kernel_results if r["kernel"] == name]
        head = rows[0]      # the main path's first (largest) shape
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=main_res["launches"][name],
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"],
            cases=[{k: v for k, v in r.items() if k != "kernel"}
                   for r in rows],
        ))

    if args.out:
        summary = dict(
            card=card, build_s=t_build, kernels=kernels,
            main={name: {k: v for k, v in r.items()
                         if k not in ("scanner", "hits")}
                  for name, r in main_res["runs"].items()},
            twins=twin_res,
            profile=prof_res,
        )
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1, default=lambda o: (
                o.tolist() if hasattr(o, "tolist") else str(o)))

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
