"""The operations and bytes of Prov-GigaPath's slide encoder, worked out
from a configuration's shapes (its ``model`` entry), never from what a
kernel does; the peaks are port_bench/counts.py's.

Operations count the matrix products (2 per multiply-add) and the two
attention products (4 d per (query, key) pair); normalisations,
activations, softmax and the branch merge are left out. A branch's pairs
are those among the tokens of each (segment, head group), as LongNet lays
them out: ceil(T / w') segments of w' = min(w, T) tokens, head group j of
a segment of lim tokens over the ceil((lim - j) / r) tokens p = j (mod r).
Zero-padded keys and queries count nothing: a pad query's row is dropped,
and a pad key adds exp(0 - m) to a denominator with no product. This is
the yardstick, kept apart from the program under test (the port's
ops/dilated_attention.branch_pairs computes the same count for its own
counter).
"""
from __future__ import annotations

from typing import List, Tuple

from port_bench.counts import BF16_FLOP_S, least_seconds


def schedule(m: dict) -> List[Tuple[int, int]]:
    return list(zip(m["segment_length"], m["dilated_ratio"]))


def branch_pairs(tokens: int, w: int, r: int, heads: int) -> int:
    """(query, key) pairs of tokens of one branch of one layer over
    ``tokens``: every full segment of w' and the last, shorter one."""
    wp = min(w, tokens)
    total = 0
    for lim, count in ((wp, tokens // wp), (tokens % wp, 1)):
        if lim and count:
            total += count * (heads // r) * sum(
                (-(-(lim - j) // r)) ** 2 for j in range(min(r, lim)))
    return total


def attention_flops(tokens: int, m: dict) -> float:
    """One layer's dilated attention: 4 d per pair, every branch."""
    d = m["embed_dim"] // m["num_heads"]
    return 4.0 * d * sum(branch_pairs(tokens, w, r, m["num_heads"])
                         for w, r in schedule(m))


def attention_bytes(tokens: int, m: dict) -> float:
    """One layer's dilated attention: bf16 q, k, v read once and the
    merged bf16 output written once, and each branch's f32 lse of its
    selected (token, head) pairs, tokens x H / r."""
    dim, heads = m["embed_dim"], m["num_heads"]
    return (4.0 * tokens * dim * 2
            + sum(4.0 * tokens * heads // r for _, r in schedule(m)))


def attention_least_seconds(tokens: int, m: dict) -> float:
    """The least time of one layer's attention: its operations at the bf16
    peak or its bytes at the memory rate, whichever is longer."""
    return least_seconds(attention_bytes(tokens, m),
                         attention_flops(tokens, m), BF16_FLOP_S)


def linear_flops(tiles: int, m: dict) -> float:
    """The slide's matrix products: the tile embedding's projection, each
    layer's q, k, v, out, fc1 and fc2 over tiles + 1 tokens, the head."""
    dim, tokens = m["embed_dim"], tiles + 1
    hidden = int(dim * m["mlp_ratio"])
    return (2.0 * tiles * m["in_chans"] * dim
            + m["depth"] * 2.0 * tokens * dim * (4 * dim + 2 * hidden)
            + 2.0 * dim * m["n_classes"])


def slide_flops(tiles: int, m: dict) -> float:
    """Every counted operation of one slide: the linears and, per layer,
    the attention pairs."""
    return linear_flops(tiles, m) + m["depth"] * attention_flops(tiles + 1,
                                                                 m)
