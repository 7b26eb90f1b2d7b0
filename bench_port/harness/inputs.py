"""The benchmark's inputs: cells, configurations, banks of DFAs and traffic.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``, its
configuration in ``bench_port/configs/<config>.json`` (with the pattern file
it names beside it) and its traffic mix in ``bench_port/traffic/<mix>.json``.
Nothing here imports the program: the DFAs are built by the benchmark's
frozen copy of the PROSITE compiler (:mod:`bench_port.reference`) and handed
to the program and to the reference alike.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent          # bench_port/
#: Where the DFAs of a bank are kept between runs of a checkout: a fixed
#: folder of the benchmark's, listed in ``.gitignore``.
CACHE_NAME = "_cache"
ALPHABET = "ACDEFGHIKLMNPQRSTVWY"


def seed_rng(seed: int, *salt) -> np.random.Generator:
    """A generator for ``seed`` (any whole number) and a salt of small ints,
    so the parts of a run draw from streams of their own."""
    return np.random.default_rng([int(seed) % (1 << 64), *salt])


# --------------------------------------------------------------------------
# Cells and configurations
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict         # the configuration file's contents
    config_dir: Path
    traffic: dict        # the traffic file's contents
    chips: int
    root: Path           # the benchmark's folder (bench_port/)


def load_cell(bench: dict, workload: str, root: Path = HERE) -> Cell:
    """The cell ``workload`` of a parsed ``BENCHMARK.json``, its
    configuration and its traffic mix read from the files they name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    cfgs = {c["name"]: c for c in bench["configs"]}
    cfg_path = root.parent / cfgs[w["config"]]["file"]
    traffic_path = root / "traffic" / f"{w['traffic']}.json"
    traffic = json.loads(traffic_path.read_text())
    if "composition" in traffic:
        table = traffic_path.parent / "compositions" / (
            f"{traffic['composition']}.json")
        traffic["composition_percent"] = json.loads(
            table.read_text())["percent"]
    return Cell(name=workload, config=json.loads(cfg_path.read_text()),
                config_dir=cfg_path.parent, traffic=traffic,
                chips=int(w["chips"]), root=root)


# --------------------------------------------------------------------------
# Banks of DFAs
# --------------------------------------------------------------------------


@dataclass
class Bank:
    """A configuration's patterns as DFAs over the 20 amino acids."""

    ids: list
    tables: list        # (n_i, 20) int32 each
    accepting: list     # (n_i,) bool each
    starts: list        # int each

    def __len__(self) -> int:
        return len(self.ids)


def read_patterns(path: Path) -> list:
    """A pattern file: one ``id<TAB>pattern`` line a signature."""
    rows = []
    for line in Path(path).read_text().splitlines():
        if line.strip():
            pid, pat = line.split("\t")
            rows.append((pid, pat))
    return rows


def _compiler_digest() -> str:
    h = hashlib.sha256()
    for name in ("regex.py", "dfa.py", "prosite.py"):
        h.update((HERE / "reference" / name).read_bytes())
    return h.hexdigest()[:16]


def load_bank(cell: Cell, cache_dir: Path | None = None) -> Bank:
    """The DFAs of the cell's pattern file, from the cache when a run of
    this checkout built them before, else built and cached. The cache key
    is a digest of the pattern file and of the compiler's sources; the
    cache is ``_cache/`` of the cell's benchmark folder unless
    ``cache_dir`` says otherwise."""
    path = cell.config_dir / cell.config["patterns"]
    cache_dir = cell.root / CACHE_NAME if cache_dir is None else cache_dir
    rows = read_patterns(path)
    key = hashlib.sha256(path.read_bytes()).hexdigest()[:16]
    cached = Path(cache_dir) / f"dfas-{key}-{_compiler_digest()}.npz"
    if cached.exists():
        with np.load(cached, allow_pickle=False) as z:
            sizes, flat = z["sizes"], z["tables"]
            acc, starts = z["accepting"], z["starts"]
        cut = np.concatenate([[0], np.cumsum(sizes)])
        return Bank(ids=[pid for pid, _ in rows],
                    tables=[flat[a:b] for a, b in zip(cut, cut[1:])],
                    accepting=[acc[a:b] for a, b in zip(cut, cut[1:])],
                    starts=[int(s) for s in starts])
    from bench_port.reference.prosite import compile_prosite

    dfas = [compile_prosite(pat) for _, pat in rows]
    bank = Bank(ids=[pid for pid, _ in rows],
                tables=[d.table.astype(np.int32) for d in dfas],
                accepting=[d.accepting.astype(bool) for d in dfas],
                starts=[int(d.start) for d in dfas])
    cached.parent.mkdir(parents=True, exist_ok=True)
    tmp = cached.with_name(f"{cached.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, sizes=np.asarray([len(t) for t in bank.tables]),
             tables=np.concatenate(bank.tables),
             accepting=np.concatenate(bank.accepting),
             starts=np.asarray(bank.starts))
    os.replace(tmp, cached)
    return bank


# --------------------------------------------------------------------------
# Traffic
# --------------------------------------------------------------------------


@dataclass
class Request:
    """One request of a scan mix: its documents in the form the program is
    handed them (a (D, L) int32 array, or a list of str), and the same as
    (D, L_max) symbol codes with their lengths, for the reference."""

    docs: object
    codes: np.ndarray     # (D, L_max) int32, padded with 0
    lengths: np.ndarray   # (D,) int64
    residues: int


def _composition(traffic: dict) -> np.ndarray:
    shares = traffic["composition_percent"]
    p = np.asarray([shares[a] for a in ALPHABET], dtype=np.float64)
    return p / p.sum()


def doc_lengths(traffic: dict, n: int) -> np.ndarray:
    """The lengths of ``n`` documents, the same set for every ``--seed``
    (a fixed ``length_seed`` in the mix), in a fixed order."""
    spec = traffic["lengths"]
    if spec["dist"] == "fixed":
        return np.full(n, int(spec["value"]), dtype=np.int64)
    if spec["dist"] == "lognormal":
        rng = np.random.default_rng(int(spec["length_seed"]))
        x = np.rint(rng.lognormal(spec["mu"], spec["sigma"], n))
        return np.clip(x, spec["min"], spec["max"]).astype(np.int64)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def scan_pool(traffic: dict, seed: int) -> list:
    """The requests of a scan mix: ``pool`` requests of ``docs`` documents
    each. The lengths are the mix's fixed set, dealt to the requests the
    same for every ``seed``, so each request has the same lengths whatever
    the seed; the seed orders the requests and the documents within each,
    and draws the residues from the mix's composition."""
    n_req, n_docs = int(traffic["pool"]), int(traffic["docs"])
    dealt = doc_lengths(traffic, n_req * n_docs).reshape(n_req, n_docs)
    order = seed_rng(seed, 1)
    dealt = dealt[order.permutation(n_req)]
    cdf = np.cumsum(_composition(traffic))
    cdf[-1] = 1.0
    rng = seed_rng(seed, 2)
    letters = np.frombuffer(ALPHABET.encode(), dtype=np.uint8)
    pool = []
    for r in range(n_req):
        lens = dealt[r][order.permutation(n_docs)]
        L = int(lens.max())
        codes = np.searchsorted(cdf, rng.random((n_docs, L))).astype(np.int32)
        codes[np.arange(L)[None, :] >= lens[:, None]] = 0
        if traffic["form"] == "array":
            if int(lens.min()) != L:
                raise ValueError("the array form needs documents of one "
                                 "length")
            docs = codes
        elif traffic["form"] == "str":
            docs = [letters[codes[d, :lens[d]]].tobytes().decode()
                    for d in range(n_docs)]
        else:
            raise ValueError(f"unknown request form {traffic['form']!r}")
        pool.append(Request(docs=docs, codes=codes, lengths=lens,
                            residues=int(lens.sum())))
    return pool


def compile_orders(traffic: dict, n_patterns: int, seed: int) -> list:
    """The orders in which a compile mix hands the bank to the program:
    ``orders`` permutations drawn once from the mix's ``order_seed``, the
    same for every ``seed``, which picks the order the loop starts from. So
    every seed compiles the same banks in the same orders, in turn."""
    rng = np.random.default_rng(int(traffic["order_seed"]))
    orders = [rng.permutation(n_patterns)
              for _ in range(int(traffic["orders"]))]
    start = int(seed_rng(seed, 3).integers(len(orders)))
    return orders[start:] + orders[:start]


class Reservoir:
    """A uniform sample of ``k`` of the window's answers, drawn from the
    seed as they come (the answers compared once the window has closed)."""

    def __init__(self, k: int, seed: int):
        self.k = int(k)
        self.rng = seed_rng(seed, 4)
        self.items: list = []
        self.seen = 0

    def offer(self, item):
        """Count one answer; keep it if it is drawn."""
        i = self.seen
        self.seen += 1
        if i < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(i + 1))
            if j < self.k:
                self.items[j] = item
