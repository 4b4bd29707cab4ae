"""Recurrent cells (port of paddle_tpu/nn/layer/rnn.py ``:21-141`` and
the gate equations of its ``_cell_step``, ``:162-188``).

``SimpleRNNCell``, ``LSTMCell`` and ``GRUCell`` keep the reference's
parameter names and shapes (``weight_ih`` (G*hidden, input), ``weight_hh``
(G*hidden, hidden), ``bias_ih`` / ``bias_hh`` (G*hidden,)), its
initialization (every parameter uniform in +-1/sqrt(hidden)) and its gate
order and equations, which are Paddle's, not ``torch.nn.GRUCell``'s: the
GRU's candidate is tanh(x Wc + r * (h Uc + bc_h)) and its update
(1 - z) * n + z * h.  A cell is called as ``cell(inputs, states)`` and
returns ``(outputs, new_states)``; ``states=None`` starts from zeros.
The ``RNN`` / ``BiRNN`` / ``SimpleRNN`` / ``LSTM`` / ``GRU`` layers are
not ported yet.  Each ``*_attr`` goes to ``create_parameter`` as in the
reference (initializer, ``trainable``, learning rate, name); a
``bias_*_attr=False`` drops that bias.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import initializer as I
from ..layer_base import Layer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell"]


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        batch = batch_ref.shape[batch_dim_idx]
        return torch.full((batch, self.hidden_size), float(init_value),
                          dtype=dtype or torch.float32,
                          device=batch_ref.device)

    def _make_params(self, gates: int, input_size: int, hidden_size: int,
                     attrs, device, generator):
        self.input_size, self.hidden_size = input_size, hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        init = I.Uniform(-std, std)
        shapes = (("weight_ih", (gates * hidden_size, input_size), False),
                  ("weight_hh", (gates * hidden_size, hidden_size), False),
                  ("bias_ih", (gates * hidden_size,), True),
                  ("bias_hh", (gates * hidden_size,), True))
        for (name, shape, is_bias), attr in zip(shapes, attrs):
            setattr(self, name, self.create_parameter(
                shape, attr, is_bias=is_bias, default_initializer=init,
                device=device, generator=generator))

    def _proj(self, x, w, b):
        y = x @ w.T
        return y if b is None else y + b

    def _gates(self, x, h):
        return (self._proj(x, self.weight_ih, self.bias_ih)
                + self._proj(h, self.weight_hh, self.bias_hh))


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = activation
        self._make_params(1, input_size, hidden_size,
                          (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                           bias_hh_attr), device, generator)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        act = torch.tanh if self.activation == "tanh" else torch.relu
        out = act(self._gates(inputs, states))
        return out, out

    @property
    def state_shape(self):
        return (self.hidden_size,)


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._make_params(4, input_size, hidden_size,
                          (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                           bias_hh_attr), device, generator)

    def forward(self, inputs, states=None):
        if states is None:
            states = (self.get_initial_states(inputs),
                      self.get_initial_states(inputs))
        h, c = states
        i, f, g, o = torch.chunk(self._gates(inputs, h), 4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c2 = f * c + i * torch.tanh(g)
        h2 = o * torch.tanh(c2)
        return h2, (h2, c2)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._make_params(3, input_size, hidden_size,
                          (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                           bias_hh_attr), device, generator)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h = states
        gi = self._proj(inputs, self.weight_ih, self.bias_ih)
        gh = self._proj(h, self.weight_hh, self.bias_hh)
        ir, iz, ic = torch.chunk(gi, 3, dim=-1)
        hr, hz, hc = torch.chunk(gh, 3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(ic + r * hc)
        h2 = (1 - z) * n + z * h
        return h2, h2

    @property
    def state_shape(self):
        return (self.hidden_size,)
