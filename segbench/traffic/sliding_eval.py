"""Sliding-window evaluation traffic (``kind: sliding_eval``): one client in a
closed loop, one frame at a time, through the port's ``sliding_predict``.

Set-up builds the configuration's model holding the benchmark's weights,
the port's predictor on it (``make_predictor`` in eval mode at
``compute_dtype``), and a pool of ``pool`` frames from the seed, made on
the device and kept on the host as the (H, W, 3) normalised float32
arrays a caller hands in; it warms up on ``warmup_frames`` frames. The
predictor is wrapped in the span ``segbench.forward``, so that a trace
tells the model's forward from the tiling and the canvas around it.

The window hands the pool's frames in, in an order drawn from the seed,
each as soon as the last class map is back on the host, until ``seconds``
have passed: ``eval_frames_per_s`` is the frames over that time,
``eval_frame_ms_p95`` the 95th percentile of every frame's time from the
array handed in to the class map returned.

The check draws ``sampled_answers`` of the window's class maps from the
seed (a reservoir sample), works out each sampled frame's canvas with the
reference in float32 without TF32, and takes the widest gap by which the
reference's logit of the class the program chose lies below its best
(``classmap_gap``, in logits; a class map of the wrong shape or with a
class outside the model's reads as infinite).

``subject="control"`` puts the reference computed in float8 in the
program's place: its class maps are judged the same way.
"""

from __future__ import annotations

import gc
import random
import sys
import time
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from segbench import devices, program, reference
from segbench.reference import sliding
from segbench.reference.precision import strict_fp32

#: the units of the end-to-end metrics :meth:`Session.window` returns
UNITS = {"eval_frames_per_s": "frames/s", "eval_frame_ms_p95": "ms"}
_FRAME_SALT = 0xF4A3
_ORDER_SALT = 0x0D
_SAMPLE_SALT = 0x5A


def make_frames(traffic: dict, config: dict, seed: int, device: torch.device):
    """``traffic["pool"]`` normalised float32 (H, W, 3) frames from ``seed``,
    drawn on ``device`` in a few calls, returned as host arrays."""
    n = traffic["pool"]
    h, w = traffic["frame"]
    g = torch.Generator(device=device).manual_seed(_FRAME_SALT ^ int(seed))
    low = torch.rand(n, 3, -(-h // 32), -(-w // 32), generator=g, device=device)
    fine = torch.rand(n, 3, h, w, generator=g, device=device)
    pixels = F.interpolate(low, size=(h, w), mode="bilinear", align_corners=False)
    pixels = (pixels * 200.0 + fine * 55.0).clamp(0, 255).round()
    mean = torch.tensor(config["norm_stats"]["mean"], device=device).view(1, 3, 1, 1)
    std = torch.tensor(config["norm_stats"]["std"], device=device).view(1, 3, 1, 1)
    frames = ((pixels / 255.0 - mean) / std).permute(0, 2, 3, 1).contiguous().cpu().numpy()
    return [frames[i] for i in range(n)]


def classmap_gap(canvas: torch.Tensor, class_map) -> float:
    """The widest gap by which ``canvas`` (classes, H, W) at the class that
    ``class_map`` (H, W) names lies below its best."""
    c, h, w = canvas.shape
    cm = torch.as_tensor(np.asarray(class_map)).to(canvas.device)
    if tuple(cm.shape) != (h, w) or cm.is_floating_point() or cm.min() < 0 or cm.max() >= c:
        return float("inf")
    chosen = canvas.gather(0, cm.long()[None])[0]
    return float((canvas.max(0).values - chosen).max())


class Session:
    """One run of an evaluation cell: set-up in the constructor, then
    :meth:`window`, :meth:`traced`, :meth:`release` and :meth:`check`."""

    unit = "frame"

    def __init__(self, cell, seed: int, device: torch.device, subject: str = "program"):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.traffic, self.config = cell.traffic, cell.config
        self.subject = subject
        phases = devices.Phases(device)
        self.frames = make_frames(self.traffic, self.config, self.seed, device)
        state = program.weights(self.config, self.seed, device)
        phases.mark("frames and weights")
        if subject == "program":
            self._build_program(state)
        else:
            with torch.device(device):
                self.control = reference.build(self.config, "fp8").eval()
            self.control.load_state_dict(state)
        del state
        phases.mark("model and predictor")
        self.order = random.Random(_ORDER_SALT ^ self.seed)
        self.sampler = random.Random(_SAMPLE_SALT ^ self.seed)
        self.sample: List[tuple] = []  # (answer index, frame index, class map)
        self.answers = 0
        self.latencies: List[float] = []
        for _ in range(self.traffic["warmup_frames"]):
            self._predict(self.order.randrange(len(self.frames)))
        phases.mark("warm-up frames")
        self.memory_peak_bytes = devices.peak_bytes(device)
        self.window_units, self.window_s = 0, 0.0

    def _build_program(self, state) -> None:
        from segtpu_torch import inference_lib

        t = self.traffic
        model = program.build_model(self.config, state, self.device)
        predict = inference_lib.make_predictor(model, compute_dtype=getattr(
            torch, t["compute_dtype"]), device=self.device)

        def forward(x):
            with torch.profiler.record_function("segbench.forward"):
                return predict(x)

        forward.device = predict.device
        self.predict_fn = forward
        self.inference = inference_lib

    def _predict(self, index: int):
        t = self.traffic
        if self.subject == "program":
            return self.inference.sliding_predict(
                self.predict_fn, self.frames[index], self.config["num_classes"],
                flip=t["flip"], tile_divisor=t["tile_divisor"], overlap=t["overlap"],
                max_tile_batch=t["max_tile_batch"], class_map=True)
        frame = torch.from_numpy(self.frames[index]).to(self.device).permute(2, 0, 1)
        with strict_fp32():
            canvas = sliding.canvas(self.control, frame, self.config["num_classes"],
                                    flip=t["flip"])
        return canvas.argmax(0).to(torch.int32).cpu().numpy()

    def _unit(self) -> None:
        index = self.order.randrange(len(self.frames))
        t0 = time.perf_counter()
        with torch.profiler.record_function("segbench.frame"):
            class_map = self._predict(index)
        self.latencies.append(time.perf_counter() - t0)
        self._keep(index, class_map)

    def _keep(self, index: int, class_map) -> None:
        """Reservoir sampling of the answers, from the seed."""
        k = self.traffic["sampled_answers"]
        if len(self.sample) < k:
            self.sample.append((self.answers, index, class_map))
        else:
            j = self.sampler.randrange(self.answers + 1)
            if j < k:
                self.sample[j] = (self.answers, index, class_map)
        self.answers += 1

    def window(self, seconds: float) -> Dict[str, float]:
        devices.synchronize(self.device)
        self.latencies = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._unit()
        elapsed = time.perf_counter() - t0
        self.memory_peak_bytes = max(self.memory_peak_bytes, devices.peak_bytes(self.device))
        self.window_units, self.window_s = len(self.latencies), elapsed
        return {"eval_frames_per_s": len(self.latencies) / elapsed,
                "eval_frame_ms_p95": 1e3 * float(np.percentile(self.latencies, 95))}

    def traced(self):
        from segbench import trace

        return trace.profile(self._unit, self.traffic["trace_frames"])

    @property
    def attempted(self) -> int:
        return self.window_units

    def release(self) -> None:
        for name in ("predict_fn", "control"):
            self.__dict__.pop(name, None)
        gc.collect()
        devices.free(self.device)

    def check(self) -> Dict[str, float]:
        state = program.weights(self.config, self.seed, self.device)
        with torch.device(self.device):
            model = reference.build(self.config, "fp32").eval()
        model.load_state_dict(state)
        del state
        canvases: Dict[int, torch.Tensor] = {}
        gaps, agree = [], []
        with strict_fp32():
            for _, index, class_map in sorted(self.sample, key=lambda s: s[1]):
                if index not in canvases:
                    canvases.clear()
                    frame = torch.from_numpy(self.frames[index]).to(self.device).permute(2, 0, 1)
                    canvases[index] = sliding.canvas(model, frame, self.config["num_classes"],
                                                     flip=self.traffic["flip"])
                gaps.append(classmap_gap(canvases[index], class_map))
                agree.append(float((canvases[index].argmax(0).cpu().numpy() == class_map).mean()))
        self.diagnostics = {"gaps": gaps, "agreement": agree,
                            "frames": [i for _, i, _ in self.sample]}
        print(f"segbench: {self.diagnostics}", file=sys.stderr)
        del model, canvases
        gc.collect()
        devices.free(self.device)
        return {"classmap_gap": max(gaps, key=lambda g: (np.isnan(g), g))}
