"""Host-side acceptance for draft-verify speculative decoding (port of
``bigdl_tpu/serving/spec/verify.py``).

The verify step returns one target-logits row per candidate position;
this module decides, row by row, which token the stream emits.  Two
modes:

- ``"replay"`` (default, the bit-exact mode): every row emits the token
  offline ``generate()`` would have picked (argmax for greedy, the
  key-chain categorical draw for sampled), and a draft is accepted
  exactly when it equals that token.  The stream is therefore always
  the offline trajectory; speculation only changes how many of its
  tokens land per verify step.  The categorical draw is Gumbel-argmax,
  so a drafter sampling with the same chain keys is Gumbel-coupled to
  the target.
- ``"rejection"``: classical speculative sampling (Leviathan et al.,
  2023): accept draft ``d`` with probability ``min(1, p(d)/q(d))``,
  else emit a draw from the normalized residual ``max(p - q, 0)``.  The
  per-token distribution is the target's, the trajectory is not the
  offline key chain's; every auxiliary draw folds the chain key, so it
  is deterministic for a fixed seed.

In both modes the emitted token equals the draft iff the draft was
accepted (a rejection residual has zero mass at ``d``), so the engine
walks rows left to right and stops at the first mismatch.  Every draw
comes from :mod:`bigdl_tpu_torch.utils.keychain`, the numpy copy of the
``jax.random`` functions the reference draws from.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from bigdl_tpu_torch.utils import keychain

#: fold_in tags deriving the rejection mode's auxiliary streams from the
#: slot's chain key: draft draw, accept coin, residual draw.
FOLD_DRAFT = 101
FOLD_ACCEPT = 103
FOLD_RESIDUAL = 107

SAMPLING_MODES = ("replay", "rejection")

DRAFTER_COMPUTE_MODES = ("dequant", "int8", "auto", "ngram")


class TreeShape:
    """A fixed-shape candidate tree for the tree verify step.

    ``parents`` lists one node per verify row: ``parents[0] == -1`` is
    the root (the slot's last emitted token) and every later node names
    an EARLIER node, so node index doubles as the arena offset its k/v
    row is written at.  The leading chain (``parents[j] == j - 1``) is
    the SPINE, the drafter's sequential proposal; every other node is an
    ALTERNATE, a ranked runner-up for one spine step, and must be a leaf
    hanging off a spine node below the tip (the drafter's dense cache
    tracks only the spine).

    Precomputed here: per-node depths (the position RoPE rotates at),
    the ancestor-or-self matrix ``anc`` (the tree attention mask),
    per-node children (the host walk's descent order), and the
    per-spine-step alternate counts the drafter fills.
    """

    def __init__(self, parents: Sequence[int]):
        parents = tuple(int(p) for p in parents)
        if len(parents) < 2 or parents[0] != -1:
            raise ValueError(
                "a tree shape needs the root (parent -1) plus at least "
                f"one candidate node, got parents={parents}")
        for j, p in enumerate(parents[1:], start=1):
            if not 0 <= p < j:
                raise ValueError(
                    f"node {j} names parent {p}; parents must be earlier "
                    "nodes (topological order)")
        self.parents = parents
        self.width = len(parents)
        depths = [0] * self.width
        anc = np.eye(self.width, dtype=bool)
        children: list = [[] for _ in range(self.width)]
        for j in range(1, self.width):
            p = parents[j]
            depths[j] = depths[p] + 1
            anc[j] |= anc[p]
            children[p].append(j)
        self.depths = tuple(depths)
        self.max_depth = max(depths)
        self.anc = anc
        self.children = tuple(tuple(c) for c in children)
        spine = 0
        while spine + 1 < self.width and parents[spine + 1] == spine:
            spine += 1
        self.spine = spine
        self.is_chain = self.width == spine + 1
        alt_counts = [0] * spine
        alt_rank = {}
        for j in range(spine + 1, self.width):
            p = parents[j]
            if p >= spine:
                raise ValueError(
                    f"alternate node {j} hangs off node {p}, but "
                    f"alternates must branch from a spine step below the "
                    f"tip (parent < {spine}): the drafter only ranks "
                    "runner-ups where it made a sequential pick")
            if self.children[j]:
                raise ValueError(
                    f"alternate node {j} has children {self.children[j]}; "
                    "alternates must be leaves")
            alt_rank[j] = alt_counts[p]
            alt_counts[p] += 1
        self.alt_counts = tuple(alt_counts)
        self.alt_rank = alt_rank

    def describe(self) -> dict:
        return {"parents": list(self.parents), "width": self.width,
                "spine": self.spine, "max_depth": self.max_depth,
                "is_chain": self.is_chain,
                "alt_counts": list(self.alt_counts)}


def default_tree_shapes(k: int, n_alt: Optional[int] = None) -> list:
    """The nested-prefix shape ladder: chain-1, chain-ceil(k/2), chain-k,
    and chain-k plus ``n_alt`` first-runner-up alternates on the lowest
    spine steps.  Every rung is a prefix of the next, so a slot at a
    lower rung rides a wider round by truncating its ``n_cand``."""
    k = int(k)
    if n_alt is None:
        n_alt = min(k, 3)
    n_alt = int(n_alt)
    if not 0 <= n_alt <= k:
        raise ValueError(f"tree_alts must be in [0, k], got {n_alt}")
    master = [-1] + list(range(k)) + list(range(n_alt))
    widths = sorted({2, (k + 1) // 2 + 1, k + 1, k + 1 + n_alt})
    return [TreeShape(master[:w]) for w in widths if 2 <= w <= len(master)]


def _validate_ladder(shapes: Sequence[TreeShape]) -> None:
    if not shapes:
        raise ValueError("tree mode needs at least one tree shape")
    for lo, hi in zip(shapes, shapes[1:]):
        if lo.width >= hi.width:
            raise ValueError(
                "tree shapes must be sorted by strictly increasing width, "
                f"got {lo.width} then {hi.width}")
        if hi.parents[:lo.width] != lo.parents:
            raise ValueError(
                f"shape ladder must be nested prefixes (so one round can "
                f"serve mixed rungs under the widest step); "
                f"{list(lo.parents)} is not a prefix of {list(hi.parents)}")


class SpecConfig:
    """Speculation knobs for :class:`~bigdl_tpu_torch.serving.LMServingEngine`.

    Args:
        k: draft tokens per verify round (the linear verify step scores
            ``k + 1`` candidate rows).
        draft: a built ``TransformerLM`` drafter on the engine's device.
            ``None`` asks for the default drafter: the target's int8
            ``quantize()`` clone (the target itself when it is already
            int8), running ``drafter_compute``; ``drafter_compute=
            "ngram"`` needs no model.
        sampling: ``"replay"`` (bit-exact vs offline generate, the
            default) or ``"rejection"`` (distribution-exact speculative
            sampling).
        drafter_compute: the default drafter's products
            (``"dequant"``, ``"int8"``, ``"auto"``; ``quant.kernels``)
            or ``"ngram"``, the zero-model prompt-lookup drafter.
        ema_alpha: weight of the newest round in the per-slot
            acceptance-rate EMA.
        demote_below: demote a slot to plain decode when its EMA falls
            below this after ``min_rounds`` speculated rounds.
        min_rounds: rounds of evidence before demotion can trigger.
        probe_interval: plain rounds a demoted slot serves before
            speculation is re-probed.
        tree: verify a candidate TREE instead of the linear chain
            (replay only): the spine budget stays ``k``, alternates ride
            the same verify pass, and per-slot depth/width adapts over
            the shape ladder from the acceptance EMA.
        tree_alts: alternates in the widest default ladder rung
            (default ``min(k, 3)``); ignored with ``tree_shapes``.
        tree_shapes: explicit shape ladder, a list of parent-pointer
            lists, nested prefixes sorted by width.
        promote_above: move a slot one rung up when its EMA reaches
            this.
        stepdown_below: move a slot one rung down when its EMA falls
            below this.
        init_rung: ladder rung new slots start at (default: the deepest
            chain rung).
        ngram_max: longest suffix n-gram the ``"ngram"`` drafter matches
            against the request's own prompt + emitted tokens.
    """

    def __init__(self, k: int = 4, *, draft=None, sampling: str = "replay",
                 drafter_compute: str = "dequant",
                 ema_alpha: float = 0.3, demote_below: float = 0.1,
                 min_rounds: int = 4, probe_interval: int = 8,
                 tree: bool = False, tree_alts: Optional[int] = None,
                 tree_shapes: Optional[Sequence[Sequence[int]]] = None,
                 promote_above: float = 0.75, stepdown_below: float = 0.35,
                 init_rung: Optional[int] = None, ngram_max: int = 3):
        self.k = int(k)
        if self.k < 1:
            raise ValueError(f"spec k must be >= 1, got {k}")
        if sampling not in SAMPLING_MODES:
            raise ValueError(f"sampling must be one of {SAMPLING_MODES}, "
                             f"got {sampling!r}")
        if drafter_compute not in DRAFTER_COMPUTE_MODES:
            raise ValueError(
                f"drafter_compute must be one of {DRAFTER_COMPUTE_MODES}, "
                f"got {drafter_compute!r}")
        if drafter_compute == "ngram":
            if draft is not None:
                raise ValueError(
                    "drafter_compute='ngram' is the zero-model drafter; "
                    "passing an explicit draft model contradicts it")
            if sampling == "rejection":
                raise ValueError(
                    "the n-gram drafter has no q distribution, so "
                    "rejection sampling cannot form p/q acceptance "
                    "ratios; use sampling='replay'")
        self.draft = draft
        self.sampling = sampling
        self.drafter_compute = drafter_compute
        self.ema_alpha = float(ema_alpha)
        if not 0.0 < self.ema_alpha <= 1.0:
            raise ValueError(f"ema_alpha must be in (0, 1], got {ema_alpha}")
        self.demote_below = float(demote_below)
        self.min_rounds = int(min_rounds)
        if self.min_rounds < 1:
            raise ValueError(f"min_rounds must be >= 1, got {min_rounds}")
        self.probe_interval = int(probe_interval)
        if self.probe_interval < 1:
            raise ValueError(
                f"probe_interval must be >= 1, got {probe_interval}")
        self.tree = bool(tree)
        if tree_shapes is not None and not self.tree:
            raise ValueError("tree_shapes requires tree=True")
        self.promote_above = float(promote_above)
        self.stepdown_below = float(stepdown_below)
        self.ngram_max = int(ngram_max)
        if self.ngram_max < 1:
            raise ValueError(f"ngram_max must be >= 1, got {ngram_max}")
        self.shapes: Optional[list] = None
        self.init_rung: Optional[int] = None
        if self.tree:
            if sampling == "rejection":
                raise ValueError(
                    "tree verify is replay-only: rejection acceptance "
                    "needs a drafter q row per node, and alternates are "
                    "ranked runner-ups without one")
            if not 0.0 < self.stepdown_below <= self.promote_above <= 1.0:
                raise ValueError(
                    "need 0 < stepdown_below <= promote_above <= 1, got "
                    f"{stepdown_below} / {promote_above}")
            if tree_shapes is not None:
                shapes = [TreeShape(p) for p in tree_shapes]
            else:
                shapes = default_tree_shapes(self.k, tree_alts)
            _validate_ladder(shapes)
            deepest = max(s.spine for s in shapes)
            if deepest > self.k:
                raise ValueError(
                    f"shape ladder spines go {deepest} deep but the "
                    f"drafter budget is k={self.k}")
            self.shapes = shapes
            if init_rung is None:
                chain_rungs = [i for i, s in enumerate(shapes) if s.is_chain]
                init_rung = chain_rungs[-1] if chain_rungs else 0
            self.init_rung = int(init_rung)
            if not 0 <= self.init_rung < len(shapes):
                raise ValueError(
                    f"init_rung {init_rung} outside the ladder "
                    f"[0, {len(shapes)})")

    def describe(self) -> dict:
        d = {"k": self.k, "sampling": self.sampling,
             "drafter_compute": self.drafter_compute,
             "ema_alpha": self.ema_alpha,
             "demote_below": self.demote_below,
             "min_rounds": self.min_rounds,
             "probe_interval": self.probe_interval,
             "tree": self.tree}
        if self.tree:
            d["tree_shapes"] = [list(s.parents) for s in self.shapes]
            d["tree_widths"] = [s.width for s in self.shapes]
            d["promote_above"] = self.promote_above
            d["stepdown_below"] = self.stepdown_below
            d["init_rung"] = self.init_rung
        if self.drafter_compute == "ngram":
            d["ngram_max"] = self.ngram_max
        return d


def pick_token(logits_row: np.ndarray, temperature: float, key,
               clamp: bool) -> int:
    """The offline sampling rule (``keychain.sample``) for one logits
    row, drawn over (1, V): argmax at temperature 0 (or without a key),
    else the key-chain categorical.  ``clamp`` divides by
    ``max(temperature, 1e-6)``, as ``generate()``'s decode steps do; its
    first token divides by the temperature itself."""
    row = np.asarray(logits_row)[None, :]
    return int(keychain.sample(key, row, temperature, clamp)[0])


def _softmax(logits: np.ndarray) -> np.ndarray:
    z = logits.astype(np.float64) - float(np.max(logits))
    e = np.exp(z)
    return e / e.sum()


def draft_pick(logits_row: np.ndarray, temperature: float, key,
               mode: str) -> int:
    """How the DRAFTER chooses its proposal: greedy without a key;
    replay mode samples with the slot's own chain key (Gumbel-coupling
    the draft to the target's draw); rejection mode draws from q with an
    independent folded key."""
    if mode == "rejection" and temperature > 0.0 and key is not None:
        key = keychain.fold_in(key, FOLD_DRAFT)
    return pick_token(logits_row, temperature, key, clamp=True)


def accept_row(target_row: np.ndarray, draft_tok: Optional[int],
               temperature: float, key, mode: str,
               draft_row: Optional[np.ndarray] = None) -> int:
    """Emit one token for one verify row.  ``draft_tok`` is None on the
    bonus row (all drafts accepted).  Returns the emitted 0-based token;
    it equals ``draft_tok`` iff the draft is accepted."""
    if (draft_tok is None or mode != "rejection"
            or temperature <= 0.0 or key is None):
        return pick_token(target_row, temperature, key, clamp=True)
    t = max(temperature, 1e-6)
    p = _softmax(np.asarray(target_row) / t)
    q = _softmax(np.asarray(draft_row) / t)
    u = float(keychain.uniform(keychain.fold_in(key, FOLD_ACCEPT)))
    d = int(draft_tok)
    if q[d] > 0.0 and u <= min(1.0, float(p[d] / q[d])):
        return d
    r = np.maximum(p - q, 0.0)
    s = float(r.sum())
    if s <= 0.0:
        # p == q exactly: the residual is empty and acceptance was
        # certain; numerically unreachable, but fall back to p
        return pick_token(target_row, temperature, key, clamp=True)
    logr = np.log(np.where(r > 0.0, r / s, 1e-300)).astype(np.float32)
    return int(keychain.categorical(keychain.fold_in(key, FOLD_RESIDUAL),
                                    logr[None, :], axis=-1)[0])


def accept_walk(target_rows: np.ndarray, drafts: Sequence[int],
                temperature: float, keys, mode: str,
                draft_rows=None) -> tuple:
    """Pure acceptance walk: emit rows left to right, stopping after the
    first non-matching emission or the bonus row.  Returns (emitted
    0-based tokens, n_accepted).  The engine inlines the same walk to
    interleave EOS and budget checks."""
    emitted: list = []
    accepted = 0
    k_eff = len(drafts)
    for j in range(k_eff + 1):
        key = keys[j] if keys is not None else None
        e = accept_row(target_rows[j], drafts[j] if j < k_eff else None,
                       temperature, key, mode,
                       draft_rows[j] if draft_rows is not None else None)
        emitted.append(e)
        if j >= k_eff or drafts[j] != e:
            break
        accepted += 1
    return emitted, accepted


def tree_accept_walk(shape: TreeShape, tokens: Sequence[int],
                     target_rows: np.ndarray, temperature: float, keys,
                     n_cand: Optional[int] = None) -> tuple:
    """Pure tree acceptance walk (replay mode): descend from the root,
    emitting the offline ``pick_token`` draw at each accepted node and
    following the child that carries it.  ``tokens[j]`` is node j's
    token (``tokens[0]`` the last emitted), ``target_rows`` its logits
    row, and ``n_cand`` truncates the shape for a slot that rode a wider
    round at a lower rung.  Returns ``(emitted, path)``, the 0-based
    emitted tokens and the accepted node indices (root included)."""
    w = shape.width if n_cand is None else int(n_cand)
    node = 0
    path = [0]
    emitted: list = []
    while True:
        key = keys[len(emitted)] if keys is not None else None
        e = pick_token(np.asarray(target_rows[node]), temperature, key,
                       clamp=True)
        emitted.append(e)
        nxt = None
        for c in shape.children[node]:
            if c < w and int(tokens[c]) == e:
                nxt = c
                break
        if nxt is None:
            return emitted, path
        node = nxt
        path.append(nxt)
