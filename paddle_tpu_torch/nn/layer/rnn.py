"""Recurrent cells and layers (port of paddle_tpu/nn/layer/rnn.py).

``SimpleRNNCell``, ``LSTMCell`` and ``GRUCell`` keep the reference's
parameter names and shapes (``weight_ih`` (G*hidden, input), ``weight_hh``
(G*hidden, hidden), ``bias_ih`` / ``bias_hh`` (G*hidden,)), its
initialization (every parameter uniform in +-1/sqrt(hidden)) and its gate
order and equations, which are Paddle's, not ``torch.nn.GRUCell``'s: the
GRU's candidate is tanh(x Wc + r * (h Uc + bc_h)) and its update
(1 - z) * n + z * h.  A cell is called as ``cell(inputs, states)`` and
returns ``(outputs, new_states)``; ``states=None`` starts from zeros.
Each ``*_attr`` goes to ``create_parameter`` as in the reference
(initializer, ``trainable``, learning rate, name); a ``bias_*_attr=False``
drops that bias.

``RNN`` runs a cell over time (a loop in PyTorch: no kernel is behind
the reference's scan either).  With ``sequence_length`` a step past a
row's length holds that row's state and outputs zeros; a reversed pass
walks the whole padded sequence from its end and masks by the original
position, so each row's reversed pass starts at its own last element.
``BiRNN`` concatenates a forward and a reversed pass.  ``SimpleRNN`` /
``LSTM`` / ``GRU`` stack ``num_layers`` of them (``direction`` "forward"
or "bidirect"), with ``dropout`` between layers only, and take and return
states in Paddle's layout, (num_layers * num_directions, B, hidden), an
(h, c) pair of those for the LSTM.  State names are the reference's
(``layers.N.cell.*``, ``layers.N.rnn_fw.cell.*`` / ``rnn_bw``).  Unlike
the reference, which drops them, the stacks pass their ``*_attr`` on to
every cell (Paddle's behaviour).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import initializer as I
from ..layer_base import Layer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "LSTM", "GRU"]


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


class RNN(Layer):
    """A cell run over time: ``(outputs, final_states)``; inputs (B, T,
    F), or (T, B, F) with ``time_major``."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse, self.time_major = is_reverse, time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        cell = self.cell
        xs = inputs if self.time_major else inputs.transpose(0, 1)
        steps, batch = xs.shape[0], xs.shape[1]
        lstm = isinstance(cell, LSTMCell)
        if initial_states is None:
            h0 = xs.new_zeros((batch, cell.hidden_size))
            state = (h0, torch.zeros_like(h0)) if lstm else h0
        else:
            init = (list(initial_states)
                    if isinstance(initial_states, (tuple, list))
                    else [initial_states])
            state = (init[0], init[1]) if lstm else init[0]
        lens = (None if sequence_length is None
                else sequence_length.to(xs.device).long())
        outs = [None] * steps
        order = range(steps - 1, -1, -1) if self.is_reverse else range(steps)
        for t in order:
            out, new = cell(xs[t], state)
            if lens is not None:
                live = (t < lens)[:, None]
                new = (tuple(torch.where(live, n, o)
                             for n, o in zip(new, state)) if lstm
                       else torch.where(live, new, state))
                out = torch.where(live, out, torch.zeros_like(out))
            state, outs[t] = new, out
        outs = torch.stack(outs)
        return (outs if self.time_major else outs.transpose(0, 1)), state


class BiRNN(Layer):
    """A forward and a reversed ``RNN``; outputs concatenated on the last
    axis, states as (forward's, backward's)."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        fw0, bw0 = (initial_states if initial_states is not None
                    else (None, None))
        out_fw, st_fw = self.rnn_fw(inputs, fw0, sequence_length)
        out_bw, st_bw = self.rnn_bw(inputs, bw0, sequence_length)
        return torch.cat([out_fw, out_bw], dim=-1), (st_fw, st_bw)


class _RNNBase(Layer):
    CELL = SimpleRNNCell

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        from .container import LayerList
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.bidirectional = direction in ("bidirect", "bidirectional")
        self.hidden_size = hidden_size
        kw = dict(weight_ih_attr=weight_ih_attr,
                  weight_hh_attr=weight_hh_attr, bias_ih_attr=bias_ih_attr,
                  bias_hh_attr=bias_hh_attr, device=device,
                  generator=generator)
        if self.CELL is SimpleRNNCell:
            kw["activation"] = activation
        dirs = 2 if self.bidirectional else 1
        self.layers = LayerList()
        for i in range(num_layers):
            size = input_size if i == 0 else hidden_size * dirs
            if self.bidirectional:
                self.layers.append(BiRNN(self.CELL(size, hidden_size, **kw),
                                         self.CELL(size, hidden_size, **kw),
                                         time_major))
            else:
                self.layers.append(RNN(self.CELL(size, hidden_size, **kw),
                                       time_major=time_major))

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from .. import functional as F
        lstm = self.CELL is LSTMCell
        dirs = 2 if self.bidirectional else 1
        out, finals = inputs, []
        for i, rnn in enumerate(self.layers):
            init = None
            if initial_states is not None:
                init = _slice_states(initial_states, i, dirs, lstm)
            out, st = rnn(out, init, sequence_length)
            finals.extend(st if self.bidirectional else [st])
            if self.dropout > 0 and i < self.num_layers - 1:
                out = F.dropout(out, self.dropout, training=self.training)
        if lstm:
            return out, (torch.stack([f[0] for f in finals]),
                         torch.stack([f[1] for f in finals]))
        return out, torch.stack(finals)


def _slice_states(states, i: int, dirs: int, lstm: bool):
    """Layer ``i``'s initial states out of Paddle's (num_layers * dirs, B,
    H) layout: one per direction (a pair of them when bidirectional)."""
    def pick(j):
        if lstm:
            return (states[0][i * dirs + j], states[1][i * dirs + j])
        return states[i * dirs + j]
    return (pick(0), pick(1)) if dirs == 2 else pick(0)


class SimpleRNN(_RNNBase):
    CELL = SimpleRNNCell


class LSTM(_RNNBase):
    CELL = LSTMCell


class GRU(_RNNBase):
    CELL = GRUCell
