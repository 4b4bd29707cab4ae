"""Fleet's data generators (counterpart of
paddle_tpu/distributed/fleet/data_generator.py): ETL scripts that turn
raw lines into the MultiSlot line protocol the datasets read.

Per sample the protocol is ``<n> v1 ... vn <n> v1 ...``: one group per
(slot, values) pair, space-joined, newline-terminated.  Subclass
``MultiSlotDataGenerator`` (int / float values) or
``MultiSlotStringDataGenerator`` (values already strings), override
``generate_sample(line)`` to return a generator factory of [(slot,
values), ...], and call ``run_from_stdin()`` (or ``run_from_memory()``,
which asks ``generate_sample(None)``).  ``generate_batch(samples)`` may
be overridden for logic across the ``set_batch`` samples of a batch.
"""
from __future__ import annotations

import sys

__all__ = ["DataGenerator", "MultiSlotDataGenerator",
           "MultiSlotStringDataGenerator"]


class DataGenerator:
    """Override `generate_sample(line)` to return a generator-factory
    yielding [(slot_name, values), ...]; optionally override
    `generate_batch(samples)` for cross-sample logic."""

    def __init__(self):
        self.batch_size_ = 32

    def set_batch(self, batch_size):
        self.batch_size_ = int(batch_size)

    def generate_sample(self, line):
        raise NotImplementedError(
            "override generate_sample(line) -> generator factory yielding "
            "[(slot, values), ...]")

    def generate_batch(self, samples):
        def local_iter():
            for s in samples:
                yield s
        return local_iter

    def _gen_str(self, userdefined):
        raise NotImplementedError(
            "use MultiSlotDataGenerator or MultiSlotStringDataGenerator")

    def _flush_batch(self, batch, out):
        for sample in self.generate_batch(batch)():
            out.write(self._gen_str(sample))

    def run_from_stdin(self):
        """Era ETL entry: parse each stdin line via generate_sample, emit
        the MultiSlot line protocol on stdout."""
        self._run_lines(sys.stdin, sys.stdout)

    def run_from_memory(self):
        """Debug/benchmark entry: generate_sample(None) supplies samples
        (one batching/flush loop — shared with run_from_stdin)."""
        self._run_lines([None], sys.stdout)

    def _run_lines(self, lines, out):
        batch = []
        for line in lines:
            for sample in self.generate_sample(line)():
                if sample is None:
                    continue
                batch.append(sample)
                if len(batch) == self.batch_size_:
                    self._flush_batch(batch, out)
                    batch = []
        if batch:
            self._flush_batch(batch, out)


class MultiSlotStringDataGenerator(DataGenerator):
    """values are pre-stringified: [("words", ["1926", "08"]), ...] ->
    "2 1926 08 ..."."""

    def _gen_str(self, userdefined):
        if not isinstance(userdefined, (list, tuple)):
            raise ValueError(
                "generate_sample must yield a list/tuple of "
                "(slot, [str, ...]) pairs")
        groups = []
        for _, values in userdefined:
            groups.append(" ".join([str(len(values))] + list(values)))
        return " ".join(groups) + "\n"


class MultiSlotDataGenerator(DataGenerator):
    """values are ints/floats; type consistency per slot is the caller's
    contract (Paddle tracks a proto_info for the same purpose)."""

    def _gen_str(self, userdefined):
        if not isinstance(userdefined, (list, tuple)):
            raise ValueError(
                "generate_sample must yield a list/tuple of "
                "(slot, [value, ...]) pairs")
        groups = []
        for _, values in userdefined:
            groups.append(" ".join(
                [str(len(values))] + [str(v) for v in values]))
        return " ".join(groups) + "\n"
