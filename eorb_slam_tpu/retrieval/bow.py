"""Bag-of-words place recognition as dense matrix math.

Replacement for DBoW2 (reference Thirdparty/DBoW2 +
include/ORBVocabulary.h + src/KeyFrameDatabase.cc). The reference walks a
6-level-10-branch vocabulary tree per descriptor (pointer chasing) and keeps
an inverted index word->keyframes. Here the vocabulary is a flat codebook of
V binary words stored as +-1 int8 rows; quantization of all N descriptors of
a frame is ONE (N,256)x(256,V) matmul (Hamming distance is an
affine function of the +-1 dot product), and database queries are one
(V,)x(V,Kmax) matmul against the stored tf-idf matrix.

Scoring follows DBoW2's L1 score (TemplatedVocabulary::score):
  s(v, w) = 1 - 0.5 * sum_i |v_i - w_i|  with v, w L1-normalized,
which equals sum_i min(v_i, w_i) for nonneg vectors — computed batched.

`KeyFrameDatabase` mirrors DetectNBestCandidates /
DetectRelocalizationCandidates semantics (reference
src/KeyFrameDatabase.cc:612,783): common-word gating, min-score thresholds,
and top-k retrieval — as masked dense reductions.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def train_vocab(desc_pm1: jnp.ndarray, n_words: int, iters: int = 8,
                seed: int = 0) -> jnp.ndarray:
    """Binary k-means on +-1 descriptors -> (V,256) int8 codebook.

    Replaces the offline DBoW2 vocabulary build; the reference ships a
    pretrained ORBvoc.txt which `load_vocab_text` can also import.
    Lloyd iterations with sign() binarization of the mean keep centroids
    binary so quantization stays a pure matmul.
    """
    desc = desc_pm1.astype(jnp.float32)
    n = desc.shape[0]
    key = jax.random.PRNGKey(seed)
    init_idx = jax.random.choice(key, n, (n_words,), replace=n < n_words)
    words = desc[init_idx]

    def step(_, words):
        sim = desc @ words.T  # (n, V), higher = closer
        assign = jnp.argmax(sim, axis=1)
        one_hot = jax.nn.one_hot(assign, n_words, dtype=jnp.float32)  # (n,V)
        sums = one_hot.T @ desc  # (V,256)
        counts = one_hot.sum(axis=0)[:, None]
        new = jnp.where(counts > 0, jnp.sign(sums + 0.5), words)
        return new

    words = jax.lax.fori_loop(0, iters, step, words)
    return words.astype(jnp.int8)


def load_vocab_text(path: str, max_words: int | None = None) -> np.ndarray:
    """Import a DBoW2 text vocabulary (ORBvoc.txt format: header `k L s w`,
    then one node per line: parent_id is_leaf d0..d31 weight). Returns the
    leaf descriptors as a (V,256) +-1 int8 codebook (reference
    include/ORBVocabulary.h / TemplatedVocabulary::loadFromTextFile)."""
    words = []
    with open(path) as f:
        f.readline()  # header
        for line in f:
            parts = line.split()
            if len(parts) < 34:
                continue
            if parts[1] == "1":  # leaf
                by = np.array([int(b) for b in parts[2:34]], np.uint8)
                bits = np.unpackbits(by)
                words.append(bits.astype(np.int8) * 2 - 1)
                if max_words and len(words) >= max_words:
                    break
    return np.stack(words)


@functools.partial(jax.jit, static_argnames=())
def quantize(desc_pm1: jnp.ndarray, feat_valid: jnp.ndarray,
             words_pm1: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Assign each descriptor to its nearest word; return (word_ids (N,),
    bow (V,) L1-normalized tf vector). One matmul for the whole frame."""
    sim = desc_pm1.astype(jnp.float32) @ words_pm1.astype(jnp.float32).T
    wid = jnp.argmax(sim, axis=1).astype(jnp.int32)
    V = words_pm1.shape[0]
    tf = jnp.zeros(V, jnp.float32).at[wid].add(feat_valid.astype(jnp.float32))
    norm = jnp.maximum(tf.sum(), 1e-9)
    return wid, tf / norm


def l1_score(bow_q: jnp.ndarray, bow_db: jnp.ndarray) -> jnp.ndarray:
    """DBoW2 L1 score, batched: (V,) query vs (Kmax,V) database -> (Kmax,).
    sum(min(q, w)) per row."""
    return jnp.minimum(bow_q[None, :], bow_db).sum(axis=1)


class KeyFrameDatabase(NamedTuple):
    """Dense inverted index: per-KF tf vectors + word presence masks."""
    bow: jnp.ndarray        # (Kmax, V) float32 L1-normalized tf
    has_word: jnp.ndarray   # (Kmax, V) bool
    valid: jnp.ndarray      # (Kmax,) bool


def empty_database(Kmax: int, V: int) -> KeyFrameDatabase:
    return KeyFrameDatabase(
        bow=jnp.zeros((Kmax, V), jnp.float32),
        has_word=jnp.zeros((Kmax, V), bool),
        valid=jnp.zeros(Kmax, bool),
    )


def add_keyframe(db: KeyFrameDatabase, slot, bow: jnp.ndarray) -> KeyFrameDatabase:
    return KeyFrameDatabase(
        bow=db.bow.at[slot].set(bow),
        has_word=db.has_word.at[slot].set(bow > 0),
        valid=db.valid.at[slot].set(True),
    )


def erase_keyframe(db: KeyFrameDatabase, slot) -> KeyFrameDatabase:
    return KeyFrameDatabase(
        bow=db.bow.at[slot].set(0.0),
        has_word=db.has_word.at[slot].set(False),
        valid=db.valid.at[slot].set(False),
    )


# --------------------------------------------------------------- hierarchical
#
# Real-vocabulary scale (ORBvoc has ~1M leaf words): a flat (V,256) codebook
# needs a 10^9-FLOP quantize matmul per frame and the dense (Kmax,V) tf
# matrix hundreds of MB. The dense-math equivalent of DBoW2's 6-level tree
# is a 2-level product: one coarse matmul picks a cell, one small batched
# matmul picks the word inside the cell — both dense matmuls — and keyframes
# store SPARSE (word_id, weight) lists sized by the feature budget.


class HierVocab(NamedTuple):
    """Two-level vocabulary: V = K1 * K2 words."""

    words1: jnp.ndarray    # (K1,256) int8 coarse centroids
    words2: jnp.ndarray    # (K1,K2,256) int8 fine words per cell
    weights: jnp.ndarray   # (K1*K2,) float32 per-word idf (ORBvoc weights)

    @property
    def K1(self):
        return self.words1.shape[0]

    @property
    def K2(self):
        return self.words2.shape[1]

    @property
    def V(self):
        return self.K1 * self.words2.shape[1]


def train_hier_vocab(desc_pm1: jnp.ndarray, K1: int = 64, K2: int = 64,
                     iters: int = 6, seed: int = 0) -> HierVocab:
    """Train a 2-level vocabulary by nested binary k-means (the offline
    DBoW2 build; the reference ships a pretrained tree instead)."""
    desc = jnp.asarray(desc_pm1)
    words1 = train_vocab(desc, K1, iters=iters, seed=seed)
    sim = desc.astype(jnp.float32) @ words1.astype(jnp.float32).T
    cell = np.asarray(jnp.argmax(sim, axis=1))
    rng = np.random.default_rng(seed + 1)
    d_np = np.asarray(desc)
    w2 = np.zeros((K1, K2, 256), np.int8)
    for c in range(K1):
        members = d_np[cell == c]
        if len(members) == 0:
            members = d_np[rng.integers(0, len(d_np), 8)]
        sub = train_vocab(jnp.asarray(members), K2,
                          iters=max(iters // 2, 2), seed=seed + 2 + c)
        w2[c] = np.asarray(sub)
    V = K1 * K2
    return HierVocab(words1=words1, words2=jnp.asarray(w2),
                     weights=jnp.ones(V, jnp.float32))


def balanced_cells(sim: np.ndarray, K2: int) -> np.ndarray:
    """Capacity-constrained cell assignment: every row of `sim` (n, K1) gets
    a cell, no cell exceeds K2 members. Greedy rounds — each unplaced row
    goes to its best non-full cell; overfull cells keep their K2 closest
    rows and release the rest to the next round. Returns (n,) cell ids."""
    n, K1 = sim.shape
    assert K1 * K2 >= n, f"capacity {K1}*{K2} < {n} leaves"
    cell = np.full(n, -1, np.int64)
    full = np.zeros(K1, bool)
    pending = np.arange(n)
    sim = sim.copy()
    while len(pending):
        pick = np.argmax(np.where(full[None, :], -np.inf, sim[pending]),
                         axis=1)
        cell[pending] = pick
        nxt = []
        for c in np.unique(pick):
            mem = np.flatnonzero(cell == c)
            if len(mem) <= K2:
                continue
            # keep the K2 best-matching members, release the rest
            order = np.argsort(-sim[mem, c])
            drop = mem[order[K2:]]
            cell[drop] = -1
            full[c] = True
            nxt.append(drop)
        # cells exactly at capacity also stop accepting
        counts = np.bincount(cell[cell >= 0], minlength=K1)
        full |= counts >= K2
        pending = np.concatenate(nxt) if nxt else np.empty(0, np.int64)
    return cell


def load_vocab_text_hier(path: str, K1: int = 256,
                         max_words: int | None = None,
                         overflow: float = 1.25) -> HierVocab:
    """Import DBoW2 leaf words + their trained idf weights from ORBvoc.txt
    and re-shape into the 2-level product form: coarse k-means over the
    leaves, then balanced cell assignment with a FIXED fine size
    K2 = ceil(overflow * V / K1) — one dense cluster in a skewed ORBvoc
    can no longer blow words2 (K1,K2,256) up to the largest cell's
    population (overfull cells spill members to their next-nearest cell).
    Word weights follow the file (TemplatedVocabulary's stored idf)."""
    leaves, wts = [], []
    with open(path) as f:
        f.readline()
        for line in f:
            parts = line.split()
            if len(parts) < 34 or parts[1] != "1":
                continue
            by = np.array([int(b) for b in parts[2:34]], np.uint8)
            leaves.append(np.unpackbits(by).astype(np.int8) * 2 - 1)
            wts.append(float(parts[34]) if len(parts) > 34 else 1.0)
            if max_words and len(leaves) >= max_words:
                break
    desc = jnp.asarray(np.stack(leaves))
    wts = np.asarray(wts, np.float32)
    K1 = min(K1, len(leaves))
    words1 = train_vocab(desc, K1, iters=6)
    sim = np.asarray(desc.astype(jnp.float32)
                     @ words1.astype(jnp.float32).T)
    K2 = int(np.ceil(overflow * len(leaves) / K1))
    cell = balanced_cells(sim, K2)
    w2 = np.zeros((K1, K2, 256), np.int8)
    wt2 = np.zeros((K1, K2), np.float32)
    leaves_np = np.stack(leaves)
    for c in range(K1):
        mem = np.flatnonzero(cell == c)
        w2[c, : len(mem)] = leaves_np[mem]
        wt2[c, : len(mem)] = wts[mem]
    return HierVocab(words1=words1, words2=jnp.asarray(w2),
                     weights=jnp.asarray(wt2.reshape(-1)))


@jax.jit
def quantize_hier(desc_pm1: jnp.ndarray, feat_valid: jnp.ndarray,
                  voc: HierVocab):
    """(N,256) descriptors -> (word_ids (N,) int32 [-1 invalid],
    weights (N,) float32). Two matmuls, no pointer chasing."""
    df = desc_pm1.astype(jnp.float32)
    cell = jnp.argmax(df @ voc.words1.astype(jnp.float32).T, axis=1)
    sub = voc.words2[cell].astype(jnp.float32)          # (N,K2,256)
    fine = jnp.argmax(jnp.einsum("nc,nkc->nk", df, sub), axis=1)
    wid = (cell * voc.words2.shape[1] + fine).astype(jnp.int32)
    wid = jnp.where(feat_valid, wid, -1)
    return wid, voc.weights[jnp.clip(wid, 0)] * feat_valid


class SparseKeyFrameDatabase(NamedTuple):
    """Per-KF sparse tf-idf word lists (Kmax, Nw): the inverted index at
    real-vocabulary scale. Rows are sorted by word id with -1 padding."""

    ids: jnp.ndarray      # (Kmax, Nw) int32 word ids, -1 = pad
    w: jnp.ndarray        # (Kmax, Nw) float32 L1-normalized tf-idf
    valid: jnp.ndarray    # (Kmax,) bool


def empty_sparse_database(Kmax: int, Nw: int) -> SparseKeyFrameDatabase:
    return SparseKeyFrameDatabase(
        ids=jnp.full((Kmax, Nw), -1, jnp.int32),
        w=jnp.zeros((Kmax, Nw), jnp.float32),
        valid=jnp.zeros(Kmax, bool),
    )


@jax.jit
def sparse_bow_row(word_ids: jnp.ndarray, weights: jnp.ndarray):
    """Aggregate per-feature words into a sorted unique (ids, tf-idf) row:
    sort by id, segment-sum equal ids into the FIRST slot of each run,
    L1-normalize. Fixed shape (N,) with -1/0 padding."""
    order = jnp.argsort(word_ids)
    ids = word_ids[order]
    ws = weights[order]
    first = jnp.concatenate([jnp.asarray([True]), ids[1:] != ids[:-1]])
    seg = jnp.cumsum(first) - 1                       # run index per entry
    agg = jnp.zeros_like(ws).at[seg].add(ws)          # weight per run
    run_id = jnp.full_like(ids, -(1 << 30)).at[seg].max(ids)
    n_runs = seg[-1] + 1
    slot = jnp.arange(ids.shape[0])
    run_valid = (slot < n_runs) & (run_id >= 0) & (agg > 0)
    out_ids = jnp.where(run_valid, run_id, -1)
    out_w = jnp.where(run_valid, agg, 0.0)
    norm = jnp.maximum(out_w.sum(), 1e-9)
    return out_ids, out_w / norm


def sparse_add_keyframe(db: SparseKeyFrameDatabase, slot,
                        word_ids: jnp.ndarray, weights: jnp.ndarray):
    ids, w = sparse_bow_row(word_ids, weights)
    return SparseKeyFrameDatabase(
        ids=db.ids.at[slot].set(ids),
        w=db.w.at[slot].set(w),
        valid=db.valid.at[slot].set(True),
    )


def sparse_erase_keyframe(db: SparseKeyFrameDatabase, slot):
    return SparseKeyFrameDatabase(
        ids=db.ids.at[slot].set(-1),
        w=db.w.at[slot].set(0.0),
        valid=db.valid.at[slot].set(False),
    )


@functools.partial(jax.jit, static_argnames=("top_k",))
def sparse_detect_candidates(
    db: SparseKeyFrameDatabase,
    q_ids: jnp.ndarray,     # (Nw,) sorted unique ids (-1 pad)
    q_w: jnp.ndarray,       # (Nw,)
    exclude_mask: jnp.ndarray,
    top_k: int = 3,
    min_common_frac: float = 0.8,
):
    """DetectNBestCandidates over the sparse index: per-KF sparse-sparse
    intersection as one (Kmax, Nq, Nw) equality einsum — common-word gate +
    L1 score (sum of min weights on shared words)."""
    eq = (q_ids[None, :, None] == db.ids[:, None, :]) & (q_ids >= 0)[None, :, None]
    common = eq.any(axis=2).sum(axis=1)
    mins = jnp.minimum(q_w[None, :, None], db.w[:, None, :])
    scores_l1 = jnp.where(eq, mins, 0.0).sum(axis=(1, 2))
    ok = db.valid & ~exclude_mask
    max_common = jnp.max(jnp.where(ok, common, 0))
    gate = ok & (common >= min_common_frac * max_common) & (common > 0)
    scores = jnp.where(gate, scores_l1, -jnp.inf)
    top_scores, top_idx = jax.lax.top_k(scores, top_k)
    return top_scores, top_idx


@functools.partial(jax.jit, static_argnames=("top_k",))
def detect_candidates(
    db: KeyFrameDatabase,
    bow_q: jnp.ndarray,
    exclude_mask: jnp.ndarray,
    top_k: int = 3,
    min_common_frac: float = 0.8,
):
    """DetectNBestCandidates semantics (reference src/KeyFrameDatabase.cc:612):
    count common words with each stored KF; gate at min_common_frac * max
    common words; L1-score the survivors; return top_k (scores, indices).

    exclude_mask: (Kmax,) bool — connected/covisible KFs to skip (the
    reference excludes the query's covisibility group).
    """
    common = (db.has_word & (bow_q > 0)[None, :]).sum(axis=1)
    ok = db.valid & ~exclude_mask
    max_common = jnp.max(jnp.where(ok, common, 0))
    gate = ok & (common >= min_common_frac * max_common) & (common > 0)
    scores = jnp.where(gate, l1_score(bow_q, db.bow), -jnp.inf)
    top_scores, top_idx = jax.lax.top_k(scores, top_k)
    return top_scores, top_idx


@jax.jit
def all_scores(db: KeyFrameDatabase, bow_q: jnp.ndarray) -> jnp.ndarray:
    """(Kmax,) L1 similarity of the query against every stored KF (invalid
    slots -> -inf). Needed for the reference's minScore gate: loop
    candidates must score at least as high as the query's WORST covisible
    neighbor (src/KeyFrameDatabase.cc:612 computes minScore over the
    covisibility group first)."""
    s = l1_score(bow_q, db.bow)
    return jnp.where(db.valid, s, -jnp.inf)


@jax.jit
def sparse_all_scores(db: SparseKeyFrameDatabase, q_ids: jnp.ndarray,
                      q_w: jnp.ndarray) -> jnp.ndarray:
    """Sparse-index variant of ``all_scores``."""
    eq = (q_ids[None, :, None] == db.ids[:, None, :]) \
        & (q_ids >= 0)[None, :, None]
    mins = jnp.minimum(q_w[None, :, None], db.w[:, None, :])
    s = jnp.where(eq, mins, 0.0).sum(axis=(1, 2))
    return jnp.where(db.valid, s, -jnp.inf)
