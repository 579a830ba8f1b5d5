"""Whole-slide bags scored by a slide encoder that takes coordinates: one
stream of slides, each one forward through the port's
``engine/serve.score_stream`` (``score_with_coords`` per slide,
Prov-GigaPath's slide encoder, ``build_mil_model("gigapath_slide")``, on
the dilated-attention kernels), with the port's own look-ahead: it issues
``serve.SCORE_AHEAD`` slides beyond the one whose answers (logits, slide
embedding, sampled rows of the last layer) it reads back.

A slide's bag is a contiguous seeded window of one pinned host pool of
tile embeddings (port_bench/weights_longnet.tile_pool), so nothing but
the copy to the card stands between the store and the card; its tiles
lie on a grid of 4096^2 cells as the other cells' slides do (store.py's
``make_slides`` and ``tissue_coords``: region by region, row-major
inside), at 256 px, no pixels made. Slide sizes: ``sizes`` regions per
slide log-uniform over the traffic's range, each size once per seeded
cycle, so every seed serves the same sizes. No slide is issued after the
first answer that arrives ``seconds`` into the window; the window ends
when the slides in flight have finished, and its rate is the tile
pixels of every slide finished in it over its length. The job list
covers the window at ``MAX_MPX_PER_S``; a run whose list runs out
fails.

Path guard: the dilated-attention wrapper must run once per layer of
every scored slide on the card, whatever device launches it makes.
"""
from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from port_bench import store
from port_bench.reference.longnet import gigapath_slide
from port_bench.reference.precision import exact_f32
from port_bench.trace import Spans
from port_bench.weights_longnet import gigapath_weights, tile_pool

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the job list covers the window at this rate, some six times the ~60,000
# Mpx/s one H100 was expected to reach on these bags
MAX_MPX_PER_S = 400_000.0
# distinct slide layouts (cells and their pinned coordinates); the job
# list takes them in turn, each with a window of the pool of its own
LAYOUT_CYCLES = 8
# token rows of the last layer read back per slide for the check: the
# bag's last ones (its last segments hold the pads) and evenly spaced ones
TAIL_ROWS = SPREAD_ROWS = 64


def token_rows(tokens: int) -> np.ndarray:
    """The last layer's rows compared per slide: the last TAIL_ROWS tokens
    and SPREAD_ROWS evenly spaced from the CLS on, ascending, each
    once."""
    return np.union1d(np.arange(max(0, tokens - TAIL_ROWS), tokens),
                      np.rint(np.linspace(0, tokens - 1, SPREAD_ROWS))
                      .astype(np.int64))


def region_sizes(lo: int, hi: int, count: int) -> np.ndarray:
    """``count`` region counts log-uniform over lo..hi: lo (hi/lo)^(i /
    (count - 1)), rounded."""
    return np.rint(lo * (hi / lo) ** (np.arange(count) / (count - 1))) \
        .astype(np.int64)


def build_model(m: dict):
    """The configuration's model through the port's ``build_mil_model``
    (the published architecture); ValueError where the configuration
    names another."""
    from hipt_abmil_atec23_tpu_torch.models.abmil import build_mil_model
    model = build_mil_model(m["port_model_type"], n_classes=m["n_classes"],
                            in_dim=m["in_chans"], dtype=DTYPES[m["dtype"]])
    enc = model.slide_encoder
    layer = enc.encoder.layers[0]
    built = dict(embed_dim=enc.norm.normalized_shape[0],
                 depth=len(enc.encoder.layers),
                 num_heads=layer.self_attn.heads,
                 mlp_ratio=layer.ffn.fc1.out_features
                 / layer.ffn.fc1.in_features,
                 segment_length=[w for w, _ in enc.schedule],
                 dilated_ratio=[r for _, r in enc.schedule],
                 tile_size=enc.tile_size, slide_ngrids=enc.ngrids,
                 ln_eps=layer.self_attn_layer_norm.eps,
                 norm_eps=enc.norm.eps)
    wrong = {k: (v, m[k]) for k, v in built.items() if v != m[k]}
    if wrong:
        raise ValueError(f"build_mil_model({m['port_model_type']!r}) builds "
                         f"another architecture than the configuration "
                         f"(built, configured): {wrong}")
    return model


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.model_cfg = config["model"]
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.spans = Spans()

    # ------------------------------------------------------------ set-up
    def setup(self, seconds: float) -> None:
        # the port's entry first: a program without it fails here, at once
        from hipt_abmil_atec23_tpu_torch.engine import serve
        self._score_stream = serve.score_stream
        t, m = self.traffic, self.model_cfg
        rng = np.random.default_rng(self.seed)
        self.pool = tile_pool(t, m["in_chans"], self.seed, self.device)
        tile, region = m["tile_size"], t["region_size"]
        sizes = region_sizes(*t["regions_per_slide"], t["sizes"])
        cells = SimpleNamespace(n=1, size=region)   # the grid, no pixels
        self.layouts = []
        for _ in range(LAYOUT_CYCLES):
            for s in store.make_slides(cells, rng.permutation(sizes),
                                       tuple(t["grid"]), rng):
                xy = torch.from_numpy(store.tissue_coords(s, tile))
                self.layouts.append(xy.pin_memory() if self.cuda else xy)
        # the rows read back for each token count, on the device
        self.rows = {len(xy) + 1: torch.from_numpy(token_rows(len(xy) + 1))
                     .to(self.device) for xy in self.layouts}
        mean_px = sizes.mean() * region ** 2
        n_jobs = int(np.ceil(MAX_MPX_PER_S * seconds * 1e6 / mean_px))
        rows = len(self.pool)
        self.jobs = [(i % len(self.layouts), int(rng.integers(
            0, rows - len(self.layouts[i % len(self.layouts)]) + 1)))
            for i in range(n_jobs)]

        with torch.device(self.device):
            model = build_model(m)
        model.load_state_dict(gigapath_weights(self.config, self.seed,
                                               self.device))
        self.state = serve.ServeState(device=self.device,
                                      model=model.eval())
        # warm every shape the window uses, as the window runs them: each
        # bag size once (the kernels build at the first; each size's
        # launch plan is kept), then as many of the largest bags in a row
        # as the stream holds in flight
        biggest = sorted(range(len(sizes)), key=lambda li: -len(
            self.layouts[li]))[:serve.SCORE_AHEAD + 1]
        self._run([(li, 0) for li in list(range(len(sizes))) + biggest])

    def _bag(self, layout: int, start: int):
        xy = self.layouts[layout]
        return self.pool[start:start + len(xy)], xy

    def _answer(self, out) -> torch.Tensor:
        """A slide's logits, slide embedding and the last layer's
        ``token_rows``, as one f32 row for one copy back."""
        tokens = out.extras["tokens"]
        return torch.cat([out.logits[0].float(),
                          out.extras["slide_embedding"][0].float(),
                          tokens[self.rows[len(tokens)]].float()
                          .reshape(-1)])

    def _run(self, jobs, seconds: float = None, t0: float = 0.0) -> List:
        """Score ``jobs`` in order through serve's stream; [(layout,
        start, answers)] in order. With ``seconds``, nothing is issued
        after the first answer that arrives ``seconds`` past ``t0`` and the
        slides in flight are finished; a job list that runs out first
        fails."""
        done, closing = [], [False]

        def slides():
            for job in jobs:
                if closing[0]:
                    return
                yield (job, *self._bag(*job))
            if seconds is not None:
                raise RuntimeError(
                    f"the job list ran out {time.perf_counter() - t0:.1f}"
                    f" s into a {seconds} s window")

        stream = self._score_stream(self.state, slides(),
                                    readback=self._answer)
        while True:
            with self.spans("score"):
                item = next(stream, None)
            if item is None:
                return done
            (layout, start), host = item
            done.append((layout, start, host.numpy()))
            if seconds is not None and time.perf_counter() - t0 >= seconds:
                closing[0] = True

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> dict:
        from hipt_abmil_atec23_tpu_torch.ops.dilated_attention import (
            dilated_attention)
        spans = self.spans = Spans()
        calls0 = dilated_attention.calls
        t0_ns, t0 = time.time_ns(), time.perf_counter()
        self.done = self._run(self.jobs, seconds, t0)
        t1 = time.perf_counter()
        if self.cuda:
            torch.cuda.synchronize(self.device)
        called = dilated_attention.calls - calls0
        depth = self.model_cfg["depth"]
        if self.cuda and called != depth * len(self.done):
            raise RuntimeError(
                f"the dilated-attention kernels ran {called} times for "
                f"{len(self.done)} scored slides of {depth} layers")
        tiles = [len(self.layouts[li]) for li, _, _ in self.done]
        px = self.model_cfg["tile_size"] ** 2
        return {
            "t0_ns": t0_ns, "spans": spans.items,
            "attempted": len(self.done), "failed": 0,
            "end_to_end": {"slide_mpx_per_s":
                           sum(tiles) * px / 1e6 / (t1 - t0)},
            "counts": {"slide_tiles": tiles},
            # the host's side: seconds inside serve's stream (issuing
            # slides and waiting for their answers)
            "host": {"score_s": sum(b - a for _, a, b in spans.items) / 1e9}}

    def free(self) -> None:
        del self.state
        if self.cuda:
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check
    def slides_to_check(self) -> List[int]:
        """The largest finished slide and ``check_slides`` - 1 others,
        drawn from the seed."""
        rng = np.random.default_rng(self.seed ^ 0xC4EC)
        sizes = np.array([len(self.layouts[li]) for li, _, _ in self.done])
        biggest = int(np.argmax(sizes))
        rest = [i for i in range(len(self.done)) if i != biggest]
        more = rng.choice(len(rest), min(self.traffic["check_slides"] - 1,
                                         len(rest)), replace=False)
        return [biggest] + [rest[k] for k in sorted(more)]

    def check(self, prec: str = "f32") -> Dict[str, float]:
        """The numbers compared, over the checked slides: the worst
        relative L2 gap of the slide embedding to the plain reference's
        (``feat_err``, over its 768 values), the worst logit gap over the
        reference's largest logit among the checked slides (``logit_err``;
        a random head puts some slides' logits near 0, where a gap over
        that slide's own largest would swing with rounding), and the
        worst relative
        L2 gap of a compared token row of the last layer (``token_err``,
        ``token_rows``: the CLS reaches the segments' pads only through
        other tokens, so a fault at the pads shows there first). With
        ``prec`` other than f32 the reference itself, in the
        configuration's control precision, stands in the program's place
        (the control)."""
        m, dev = self.model_cfg, self.device
        c, d = m["n_classes"], m["embed_dim"]
        feat_err = token_err = logit_gap = logit_top = 0.0
        with exact_f32():
            w = gigapath_weights(self.config, self.seed, dev)
            for i in self.slides_to_check():
                layout, start, answer = self.done[i]
                bag, xy = self._bag(layout, start)
                bag, xy = bag.to(dev), xy.to(dev)
                rows = self.rows[len(xy) + 1]
                e_ref, l_ref, t_ref = gigapath_slide(bag, xy, w, m)
                if prec == "f32":
                    got = torch.from_numpy(answer).to(dev)
                    l_got, e_got = got[:c], got[c:c + d]
                    t_got = got[c + d:].view(-1, d)
                else:
                    e_got, l_got, t_got = gigapath_slide(
                        bag, xy, w, m, m["control_precision"])
                    t_got = t_got[rows]
                t_ref = t_ref[rows]
                feat_err = max(feat_err, ((e_got - e_ref).norm()
                                          / e_ref.norm()).item())
                logit_gap = max(logit_gap, (l_got - l_ref).abs().max().item())
                logit_top = max(logit_top, l_ref.abs().max().item())
                token_err = max(token_err, ((t_got - t_ref).norm(dim=1)
                                            / t_ref.norm(dim=1)).max()
                                .item())
        return {"feat_err": feat_err, "logit_err": logit_gap / logit_top,
                "token_err": token_err}
