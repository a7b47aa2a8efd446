"""Faults planted in the program, to show that the check catches them.

Each is a context manager that patches the port while a session is built
and run. For training: the step leaves the state unchanged; the step takes
half of the batch (the loss is the mean over the rest); the dropouts
pass their input through (a rate of 0 in place of the stated one). For
evaluation:
the flipped half of the tiles is left out (the canvas is the mean over the
rest); the class map is altered where it is produced. One chip has no
exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import numpy as np


@contextlib.contextmanager
def unchanged_state():
    from segtpu_torch.core import state

    def apply_gradients(self):
        self.step += 1

    with mock.patch.object(state.TrainState, "apply_gradients", apply_gradients):
        yield


@contextlib.contextmanager
def half_batch():
    from segtpu_torch.core import steps

    make = steps.make_train_step

    def make_half(*args, **kwargs):
        step = make(*args, **kwargs)

        def half(state, images, labels, rows=None):
            n = images.shape[0] // 2
            return step(state, images[:n], labels[:n], rows)

        return half

    with mock.patch.object(steps, "make_train_step", make_half):
        yield


@contextlib.contextmanager
def dropout_off():
    import torch

    with mock.patch.object(torch.nn.Dropout, "forward", lambda self, x: x):
        yield


@contextlib.contextmanager
def flips_left_out():
    from segtpu_torch import inference_lib

    predict = inference_lib.sliding_predict

    def unflipped(*args, **kwargs):
        return predict(*args, **{**kwargs, "flip": False})

    with mock.patch.object(inference_lib, "sliding_predict", unflipped):
        yield


@contextlib.contextmanager
def altered_class_map():
    from segtpu_torch import inference_lib

    predict = inference_lib.sliding_predict

    def altered(predict_fn, image, num_classes, **kwargs):
        out = np.array(predict(predict_fn, image, num_classes, **kwargs))
        h, w = out.shape[:2]
        block = out[h // 4:h // 4 + max(h // 16, 1), w // 4:w // 4 + max(w // 16, 1)]
        block[...] = (block + 1) % num_classes
        return out

    with mock.patch.object(inference_lib, "sliding_predict", altered):
        yield


#: the faults each traffic kind can have
FAULTS = {"train_step": {"unchanged_state": unchanged_state, "half_batch": half_batch,
                         "dropout_off": dropout_off},
          "sliding_eval": {"flips_left_out": flips_left_out,
                           "altered_class_map": altered_class_map}}
