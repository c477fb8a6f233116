"""Roofline of a dry-run cell, per rank, on one NVIDIA H100.

The counterpart of ``repro.launch.roofline``, with the H100's constants in
place of the v5e's (NVIDIA H100 SXM data sheet, dense, at the 700 W power
limit): 989e12 FLOP/s in bf16, 3.35e12 B/s of HBM, 450e9 B/s of NVLink each
way.  The three terms, in seconds a rank:

    compute    = FLOPs / peak FLOP/s
    memory     = bytes accessed / HBM rate
    collective = collective bytes / NVLink rate

The port's dry run counts eagerly on the meta device, where every layer
runs, so its totals are of the full depth directly; the depth probes
(:func:`probe_configs`, :func:`extrapolate_depth`) are kept so the two can
be compared: with no fusion to differ between depths, an eager count is
exactly linear in the layers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS = 989e12       # bf16 / card
HBM_BW = 3.35e12          # bytes/s / card
LINK_BW = 450e9           # bytes/s / card, NVLink, each way

TERM_KEYS = ("flops", "bytes_accessed", "collective_bytes")


@dataclasses.dataclass
class Probe:
    """Raw per-rank numbers of one counted run."""

    flops: float
    bytes_accessed: float
    collective_bytes: float

    def __sub__(self, o: "Probe") -> "Probe":
        return Probe(self.flops - o.flops,
                     self.bytes_accessed - o.bytes_accessed,
                     self.collective_bytes - o.collective_bytes)

    def __add__(self, o: "Probe") -> "Probe":
        return Probe(self.flops + o.flops,
                     self.bytes_accessed + o.bytes_accessed,
                     self.collective_bytes + o.collective_bytes)

    def scale(self, k: float) -> "Probe":
        return Probe(self.flops * k, self.bytes_accessed * k, self.collective_bytes * k)


def extrapolate_depth(p1: Probe, p2: Probe, depth: int, *, repeats: float = 1.0) -> Probe:
    """probe(1) + (depth-1)*(probe(2)-probe(1)), then x repeats; per-layer
    deltas clamped at 0."""
    per_layer = p2 - p1
    per_layer = Probe(max(per_layer.flops, 0.0),
                      max(per_layer.bytes_accessed, 0.0),
                      max(per_layer.collective_bytes, 0.0))
    return (p1 + per_layer.scale(depth - 1)).scale(repeats)


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """No-overlap bound: the dominant term is the floor; report max."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """model-useful compute time / bound step time (per rank)."""
        if self.step_s == 0:
            return 0.0
        return (self.model_flops / PEAK_FLOPS) / self.step_s

    memory_floor_s: float = 0.0   # arguments + saved tensors, read once

    def as_dict(self) -> Dict[str, float]:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "memory_floor_s": self.memory_floor_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_s": self.step_s,
            "model_flops_per_device": self.model_flops,
            "hlo_flops_per_device": self.hlo_flops,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "roofline_fraction_floor": self.roofline_fraction_floor,
        }

    @property
    def roofline_fraction_floor(self) -> float:
        """Fraction against the touch-once bound: eager ops re-read what a
        fused kernel keeps on chip, so the floor uses the arguments and
        the saved tensors read once instead of every op's operands."""
        bound = max(self.compute_s, self.memory_floor_s, self.collective_s)
        if bound == 0:
            return 0.0
        return (self.model_flops / PEAK_FLOPS) / bound


def derive(total: Probe, *, model_flops_per_device: float) -> Roofline:
    return Roofline(
        compute_s=total.flops / PEAK_FLOPS,
        memory_s=total.bytes_accessed / HBM_BW,
        collective_s=total.collective_bytes / LINK_BW,
        model_flops=model_flops_per_device,
        hlo_flops=total.flops,
    )


def model_flops(cfg, shape, num_devices: int) -> float:
    """Analytic useful FLOPs per device per step.

    train: 6 * N_active * tokens; prefill: 2 * N_active * tokens;
    decode: 2 * N_active * batch (one token per sequence).
    """
    n = cfg.active_param_count()
    if shape.kind == "train":
        total = 6.0 * n * shape.tokens
    elif shape.kind == "prefill":
        total = 2.0 * n * shape.tokens
    else:  # decode
        total = 2.0 * n * shape.global_batch
    return total / num_devices


def probe_configs(cfg):
    """Probe configs per family: ((cfg...,), total_fn).  Hybrid probes
    difference whole macro blocks (the tail approximated as a share of a
    macro); encdec uses three probes to separate the two stacks."""
    if cfg.family == "hybrid":
        num_macro = cfg.num_layers // cfg.attn_every
        tail = cfg.num_layers - num_macro * cfg.attn_every
        c1 = dataclasses.replace(cfg, num_layers=cfg.attn_every, unroll_layers=True)
        c2 = dataclasses.replace(cfg, num_layers=2 * cfg.attn_every, unroll_layers=True)

        def total(p1, p2):
            per_macro = p2 - p1
            t = p1 + per_macro.scale(num_macro - 1)
            return t + per_macro.scale(tail / cfg.attn_every)

        return (c1, c2), total
    if cfg.family == "encdec":
        c11 = dataclasses.replace(cfg, encoder_layers=1, decoder_layers=1,
                                  unroll_layers=True)
        c21 = dataclasses.replace(cfg, encoder_layers=2, decoder_layers=1,
                                  unroll_layers=True)
        c12 = dataclasses.replace(cfg, encoder_layers=1, decoder_layers=2,
                                  unroll_layers=True)

        def total3(p11, p21, p12):
            per_enc = p21 - p11
            per_dec = p12 - p11
            return (p11 + per_enc.scale(cfg.encoder_layers - 1)
                    + per_dec.scale(cfg.decoder_layers - 1))

        return (c11, c21, c12), total3
    c1 = dataclasses.replace(cfg, num_layers=1, unroll_layers=True)
    c2 = dataclasses.replace(cfg, num_layers=2, unroll_layers=True)

    def total2(p1, p2):
        return extrapolate_depth(p1, p2, cfg.num_layers)

    return (c1, c2), total2
