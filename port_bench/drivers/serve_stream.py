"""Slide serving on the plane rung: one closed stream of whole slides from
the store through the port's ``engine/encode.encode_stream`` and each
finished slide's score through ``engine/serve._mil_bucketed`` (CLAM_SB on
the B.2 pool at serve's power-of-two bucket), as ``serve_once`` runs them.

The encoder is the configuration's (``encoder.kind``: ``hipt4k`` on
regions, ``resnet`` on patches); the traffic gives the item size, the
slide sizes in regions, the grid, the pool and how much to compare. The
window ends at the first slide finished after ``seconds``; its rate is
the pixels of the slides finished in it over its length. The job list is
sized from ``seconds`` at ``MAX_MPX_PER_S``; a run whose list runs out
before the deadline fails, so the window is never cut short.

Path guards: a batch on a rung other than the planes, or a B.2 launch
count other than one per scored slide, fails the run.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from port_bench import store, weights
from port_bench.reference import clam, ycc
from port_bench.reference.hipt4k import hipt4k
from port_bench.reference.precision import exact_f32
from port_bench.reference.resnet import resnet
from port_bench.trace import Spans

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the job list covers the window at this rate, some six times the fastest
# cell's on one H100 (HIPT_4K, ~1020 Mpx/s)
MAX_MPX_PER_S = 6000.0


def build_encoder_model(enc: dict, device):
    """The port's encoder at the configuration's widths and precision, its
    parameters on the device (no host-side init), weights not yet
    loaded."""
    dtype = DTYPES[enc["dtype"]]
    with torch.device(device):
        if enc["kind"] == "hipt4k":
            from hipt_abmil_atec23_tpu_torch.models.hipt import (
                make_hipt_encoder)
            from hipt_abmil_atec23_tpu_torch.models.vit import (
                ViT4KConfig, ViTConfig)
            if enc["block"] != "fused":
                raise ValueError("the hipt4k configurations run fused blocks")
            return make_hipt_encoder(
                dtype, use_fused_block=True,
                vit256_cfg=ViTConfig(**enc["vit256"]),
                vit4k_cfg=ViT4KConfig(**enc["vit4k"]))
        if enc["kind"] == "resnet":
            from hipt_abmil_atec23_tpu_torch.models.resnet import (
                Bottleneck, ResNetTrunk)
            model = ResNetTrunk(Bottleneck, tuple(enc["layers"]), dtype)
            if model.conv1.out_channels != enc["stem_width"]:
                raise ValueError("the port's ResNet stem is 64 wide")
            return model
    raise ValueError(f"unknown encoder kind {enc['kind']!r}")


def build_head(head: dict, device):
    from hipt_abmil_atec23_tpu_torch.models.abmil import build_mil_model
    with torch.device(device):
        model = build_mil_model("clam_sb", size_arg=head["size_arg"],
                                n_classes=head["n_classes"],
                                gate=head["gate"])
    if list(model.size) != list(head["size"]):
        raise ValueError(f"size_arg {head['size_arg']!r} is {model.size}, "
                         f"the configuration says {head['size']}")
    return model


def reference_features(enc: dict, w, y, cb, cr, prec: str) -> torch.Tensor:
    x = ycc.normalised(ycc.planes_to_rgb(y, cb, cr), enc["normalize"])
    if enc["kind"] == "hipt4k":
        return hipt4k(x, w, enc, prec)
    return resnet(x, w, enc, prec)


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.enc = config["encoder"]
        self.item = self.enc["input_size"]
        self.spans = Spans()

    # ------------------------------------------------------------ set-up
    def setup(self, seconds: float) -> None:
        from hipt_abmil_atec23_tpu_torch.engine.encode import build_encoder
        from hipt_abmil_atec23_tpu_torch.engine.serve import ServeState
        from hipt_abmil_atec23_tpu_torch.utils.config import EncoderConfig
        t, enc = self.traffic, self.enc
        rng = np.random.default_rng(self.seed)
        self.pool = store.PlanePool(self.seed, t["pool_regions"],
                                    t["region_size"], self.device)
        lo, hi = t["regions_per_slide"]
        n_slides = int(np.ceil(MAX_MPX_PER_S * seconds * 1e6
                               / ((lo + hi) / 2 * t["region_size"] ** 2)))
        slides = store.make_slides(
            self.pool, store.slide_sizes(lo, hi, n_slides, rng),
            tuple(t["grid"]), rng)
        self.jobs = [(f"slide{i:05d}", s, store.tissue_coords(s, self.item))
                     for i, s in enumerate(slides)]
        warm = store.make_slides(self.pool, np.asarray(t["warm_slides"]),
                                 tuple(t["grid"]), rng)
        self.warm_jobs = [(f"warm{i}", s, store.tissue_coords(s, self.item))
                          for i, s in enumerate(warm)]

        model = build_encoder_model(enc, self.device)
        model.load_state_dict(weights.encoder_weights(
            self.config, self.seed, self.device))
        self.encoder = build_encoder(
            EncoderConfig(model_type=enc["port_model_type"],
                          dtype=enc["dtype"], batch_size=enc["batch_size"],
                          hipt_features=enc.get("features", "cls4k")),
            device=self.device, model=model)
        head = build_head(self.config["head"], self.device)
        head.load_state_dict(weights.head_weights(self.config, self.seed,
                                                  self.device))
        self.state = ServeState(device=self.device, model=head.eval())

        # warm every shape the window uses: the encoder's batch (full and
        # tail-padded) through the stream, and each head bucket once
        for sid, feats in self._stream(self.warm_jobs, {}):
            self._score(feats)
        per = (t["region_size"] // self.item) ** 2
        for b in sorted({max(512, 1 << (n * per - 1).bit_length())
                         for n in range(lo, hi + 1)}):
            self._score(np.ones((b, self.encoder.feat_dim), np.float32))

    def _stream(self, jobs, stats):
        from hipt_abmil_atec23_tpu_torch.engine.encode import encode_stream
        return encode_stream(jobs, self.encoder, patch_level=0,
                             region_size=self.item, adaptive_rungs=False,
                             stats=stats)

    def _score(self, feats):
        """serve's scoring of one slide, its answers on the host: (logits,
        probabilities, raw scores of the slide's rows)."""
        from hipt_abmil_atec23_tpu_torch.engine.serve import _mil_bucketed
        out = _mil_bucketed(self.state, feats)
        return (out.logits[0].float().cpu().numpy(),
                out.y_prob[0].float().cpu().numpy(),
                out.a_raw[0].float().cpu().numpy()[:len(feats)])

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> dict:
        from hipt_abmil_atec23_tpu_torch.ops.gated_attention_pool import (
            gated_attention_pool)
        spans, enc = self.spans, self.encoder
        calls = [0]
        apply_yuv = enc.apply_yuv

        def counted(*a):
            calls[0] += 1
            return apply_yuv(*a)

        enc.apply_yuv = counted
        launches0 = gated_attention_pool.launches
        log0 = len(self.pool.log)
        stats: Dict = {}
        self.done: List = []
        t0_ns, t0 = time.time_ns(), time.perf_counter()
        gen = self._stream(self.jobs, stats)
        while True:
            with spans("stream"):
                item = next(gen, None)
            if item is None:
                raise RuntimeError(
                    f"the job list ran out {time.perf_counter() - t0:.1f} s "
                    f"into a {seconds} s window")
            sid, feats = item
            with spans("score"):
                answers = self._score(feats)
            self.done.append((sid, feats, *answers))
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
        gen.close()
        enc.apply_yuv = apply_yuv
        if self.cuda:
            torch.cuda.synchronize(self.device)

        other = {k: stats.get(f"regions_{k}", 0) for k in ("rgb", "dct")}
        if any(other.values()) or not stats.get("regions_yuv"):
            raise RuntimeError(f"a batch left the plane rung: {stats}")
        launched = gated_attention_pool.launches - launches0
        if self.cuda and launched != len(self.done):
            raise RuntimeError(f"B.2 ran {launched} times for "
                               f"{len(self.done)} scored slides")
        jobs = {sid: c for sid, _, c in self.jobs}
        n_items = [len(jobs[sid]) for sid, *_ in self.done]
        reads = self.pool.log[log0:]
        dispatched = reads[:calls[0]]
        for t_a, t_b, _ in reads:
            spans.add("read", t_a, t_b)
        px = self.item ** 2
        batch_items = [p // px for _, _, p in dispatched]
        read_ns, read_px = (sum(b - a for a, b, _ in reads),
                            sum(p for _, _, p in reads))
        return {
            "t0_ns": t0_ns, "spans": spans.items,
            "attempted": len(self.done), "failed": 0,
            "end_to_end": {"slide_mpx_per_s":
                           sum(n_items) * px / 1e6 / (t1 - t0)},
            "counts": {
                "batch_items": batch_items,
                "items_dispatched": sum(batch_items),
                "slide_items": n_items,
                "read_ns": read_ns,
                "read_px": read_px},
            # the host's side of every run, traced or not: the store's read
            # time per Mpx (a pure host memory copy, so a host that runs
            # slow shows in it) and the seconds the window's loop spent in
            # the stream and in scoring
            "host": {"read_ms_per_mpx": read_ns / max(read_px, 1),
                     **{f"{n}_s": sum(b - a for m, a, b in spans.items
                                      if m == n) / 1e9
                        for n in ("stream", "score")}}}

    def free(self) -> None:
        del self.encoder, self.state
        if self.cuda:
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check
    def outputs_to_check(self):
        """(rows, slides): the seeded sample of finished items, as (slide
        index in done, item index), and of finished slides, the one with
        the most items among them. The rows are drawn slot by slot of the
        encoder's batch (a slide's batches start at its first item), the
        same number from each, and hold an item of a tail-padded batch
        where one finished, so a fault in one slot or in the tail's
        padding cannot fall outside the sample."""
        rng = np.random.default_rng(self.seed ^ 0xC4EC)
        t, bs = self.traffic, self.enc["batch_size"]
        sizes = np.array([len(d[1]) for d in self.done])
        slide = np.repeat(np.arange(len(sizes)), sizes)
        item = np.arange(sizes.sum()) - np.repeat(np.cumsum(sizes) - sizes,
                                                  sizes)
        slot = item % bs
        per = max(1, t["check_items"] // bs)
        pick = []
        for s in range(bs):
            cand = np.flatnonzero(slot == s)
            pick.extend(rng.choice(cand, min(per, len(cand)), replace=False))
        tail = np.flatnonzero(item >= (sizes // bs * bs)[slide])
        if len(tail) and not np.isin(pick, tail).any():
            pick.append(rng.choice(tail))
        rows = [(int(slide[k]), int(item[k])) for k in sorted(pick)]
        biggest = int(np.argmax(sizes))
        rest = [i for i in range(len(self.done)) if i != biggest]
        more = rng.choice(len(rest), min(t["check_slides"] - 1, len(rest)),
                          replace=False)
        return rows, [biggest] + [rest[k] for k in sorted(more)]

    def reference_rows(self, rows, w, prec: str) -> torch.Tensor:
        jobs = {sid: (s, c) for sid, s, c in self.jobs}
        out = []
        for i in range(0, len(rows), self.traffic["check_block"]):
            planes = [[], [], []]
            for di, j in rows[i:i + self.traffic["check_block"]]:
                slide, coords = jobs[self.done[di][0]]
                for acc, p in zip(planes, slide.read_regions_planes(
                        coords[j:j + 1], 0, (self.item, self.item))):
                    acc.append(p)
            y, cb, cr = (torch.from_numpy(np.concatenate(p)).to(self.device)
                         for p in planes)
            out.append(reference_features(self.enc, w, y, cb, cr, prec))
        return torch.cat(out)

    def check(self, prec: str = "f32") -> Dict[str, float]:
        """The numbers compared: the worst row's relative L2 gap of the
        program's features to the reference's (``feat_err``), and on the
        program's features of sampled slides, the head's worst gap of a
        raw score over the reference's largest (``score_err``) and of a
        logit over the reference's largest (``logit_err``; random heads on
        ResNet features saturate the probabilities, so a probability gap
        could not fail). With ``prec`` other than f32 the reference itself,
        in the configuration's control precision, stands in the program's
        place (the control)."""
        rows, slides = self.outputs_to_check()
        dev = self.device
        with exact_f32():
            w = weights.encoder_weights(self.config, self.seed, dev)
            want = self.reference_rows(rows, w, "f32")
            if prec == "f32":
                got = torch.from_numpy(np.stack(
                    [self.done[i][1][j] for i, j in rows])).to(dev)
            else:
                got = self.reference_rows(rows, w, self.config["encoder"]
                                          ["control_precision"])
            del w
            feat_err = ((got - want).norm(dim=1)
                        / want.norm(dim=1).clamp(min=1e-30)).max().item()
            wh = weights.head_weights(self.config, self.seed, dev)
            score_err = logit_err = 0.0
            for i in slides:
                feats = torch.from_numpy(self.done[i][1]).to(dev)
                s_ref, l_ref, _ = clam.clam_sb(feats, wh, "f32")
                if prec == "f32":
                    l_got = torch.from_numpy(self.done[i][2]).to(dev)
                    s_got = torch.from_numpy(self.done[i][4]).to(dev)
                else:
                    s_got, l_got, _ = clam.clam_sb(
                        feats, wh, self.config["head"]["control_precision"])
                score_err = max(score_err, ((s_got - s_ref).abs().max()
                                            / s_ref.abs().max()).item())
                logit_err = max(logit_err, ((l_got - l_ref).abs().max()
                                            / l_ref.abs().max()).item())
        return {"feat_err": feat_err, "score_err": score_err,
                "logit_err": logit_err}
