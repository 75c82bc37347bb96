"""Keyframe database: loop and relocalization candidate retrieval (port of
``orbslam2_tpu.map.keyframe_database``).

DBoW2's inverted file becomes a dense (K, W) matrix of float16 BoW rows on
the host; retrieval scores the query against the live rows over the query's
nonzero words. The gates are the reference's: minCommonWords = 0.8 x the
most common words, candidate score >= minScore, scores accumulated over
each candidate's top-10 covisibility group, groups >= 0.75 x the best
accumulated score, the best keyframe of each group. The BoW vectors come
from kernel Y on the database's device (``ops/bow.py``), the vocabulary
uploaded there once.

The rows are kept in float16, as the reference keeps them: the candidate
lists depend on that rounding, and the checkpoint stores it.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..device import resolve as resolve_device
from ..ops import bow
from .state import MapState


class KeyFrameDatabase:
    def __init__(self, map_state: MapState, vocab_bits: Optional[np.ndarray] = None,
                 n_words: int = bow.VOCAB_SIZE, idf: Optional[np.ndarray] = None,
                 device=None):
        self.map = map_state
        self.device = resolve_device(map_state.device if device is None else device)
        if vocab_bits is not None:
            self.vocab, self.idf = vocab_bits, idf
        else:
            self.vocab, self.idf = bow.default_vocabulary(n_words)
        K = map_state.kf_valid.shape[0]
        self.bow_mat = np.zeros((K, self.vocab.shape[0]), np.float16)
        self.in_db = np.zeros(K, bool)
        self._vocab_dev: Optional[torch.Tensor] = None
        self._idf_dev: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------
    def compute_bow(self, desc: torch.Tensor, valid: torch.Tensor) -> np.ndarray:
        """The (W,) float32 BoW vector of (N, 32) descriptors (tensors on
        the database's device; kernel Y there), copied to the host."""
        if self._vocab_dev is None:
            self._vocab_dev = torch.from_numpy(
                bow.pack_vocabulary(self.vocab)).to(self.device)
            self._idf_dev = (None if self.idf is None else
                             torch.from_numpy(np.asarray(self.idf, np.float32))
                             .to(self.device))
        return bow.bow_vector(desc, valid, self._vocab_dev,
                              self._idf_dev).cpu().numpy()

    def row(self, kf: int) -> np.ndarray:
        """The BoW vector of keyframe ``kf``: its cached row, else computed
        from the keyframe's features on the device mirror."""
        if kf < self.bow_mat.shape[0] and self.bow_mat[kf].any():
            return self.bow_mat[kf]
        m = self.map
        with m.lock:
            mir = m.dev_kf.ensure(m)
            vec = self.compute_bow(mir["kf_desc"][kf], mir["kf_feat_valid"][kf])
        if kf < self.bow_mat.shape[0]:
            self.bow_mat[kf] = vec
        return vec

    def add(self, kf: int):
        m = self.map
        if kf >= self.bow_mat.shape[0]:  # the map's arrays grew: follow
            extra = m.kf_valid.shape[0] - self.bow_mat.shape[0]
            self.bow_mat = np.pad(self.bow_mat, ((0, extra), (0, 0)))
            self.in_db = np.pad(self.in_db, (0, extra))
        self.row(kf)
        self.in_db[kf] = True

    def erase(self, kf: int):
        self.in_db[kf] = False
        self.bow_mat[kf] = 0.0

    # ------------------------------------------------------------------
    def _candidate_scores(self, query_bow: np.ndarray, exclude: np.ndarray):
        live = self.in_db & self.map.kf_valid
        live[exclude[exclude >= 0]] = False
        if not live.any():
            return None
        # only the query's nonzero columns: rows are L1-normalized, so
        # L1(a, q) = sum_nz |a - q| + (1 - sum_nz a)
        rows = np.where(live)[0]
        nz = np.where(query_bow > 0)[0]
        q = query_bow[nz].astype(np.float32)
        db = self.bow_mat[np.ix_(rows, nz)].astype(np.float32)
        scores = np.full(live.shape[0], -1.0, np.float32)
        ncommon = np.zeros(live.shape[0], np.int32)
        l1 = np.abs(db - q[None, :]).sum(-1) + 1.0 - db.sum(-1)
        scores[rows] = 1.0 - 0.5 * l1
        ncommon[rows] = (db > 0).sum(-1)
        return scores, ncommon, live

    def detect_loop_candidates(self, kf: int, min_score: float) -> List[int]:
        """DetectLoopCandidates: the query's covisible keyframes excluded."""
        covis = self.map.covisible_keyframes(kf)
        exclude = np.concatenate([covis, [kf]]).astype(np.int64)
        return self.detect_loop_candidates_from_bow(self.bow_mat[kf], min_score,
                                                    exclude)

    def detect_loop_candidates_from_bow(self, query_bow: np.ndarray,
                                        min_score: float,
                                        exclude: Optional[np.ndarray] = None
                                        ) -> List[int]:
        if exclude is None:
            exclude = np.zeros(0, np.int64)
        out = self._candidate_scores(query_bow, exclude)
        if out is None:
            return []
        return self._group_accumulate(*out, min_score)

    def detect_relocalization_candidates(self, query_bow: np.ndarray) -> List[int]:
        """DetectRelocalizationCandidates: no minScore, no exclusion."""
        out = self._candidate_scores(query_bow, np.zeros(0, np.int64))
        if out is None:
            return []
        return self._group_accumulate(*out, min_score=-1.0)

    def _group_accumulate(self, scores, ncommon, live, min_score) -> List[int]:
        m = self.map
        max_common = ncommon.max(initial=0)
        if max_common == 0:
            return []
        min_common = int(0.8 * max_common)
        cand = np.where(live & (ncommon > min_common) & (scores >= min_score))[0]
        if len(cand) == 0:
            return []
        # accumulate over each candidate's top-10 covisibility group
        acc_scores = []
        best_in_group = []
        for c in cand:
            group = np.concatenate([[c], m.covisible_keyframes(int(c), 10)])
            gs = np.where(live[group], scores[group], 0.0)
            acc_scores.append(float(np.clip(gs, 0, None).sum()))
            best_in_group.append(int(group[int(np.argmax(gs))]))
        acc_scores = np.asarray(acc_scores)
        keep = acc_scores >= 0.75 * acc_scores.max()
        # the groups' best keyframes, once each, by accumulated score
        seen = set()
        result = []
        for i in np.argsort(-acc_scores):
            b = best_in_group[i]
            if keep[i] and b not in seen:
                seen.add(b)
                result.append(b)
        return result
