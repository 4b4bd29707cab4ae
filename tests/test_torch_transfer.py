"""paddle_tpu_torch's run-transfer codec against the JAX package's on the CPU.

A run preempted in one framework's engine crosses the wire form
(``run_to_bytes``) into the other framework's engine, of the other KV
layout, and continues the stream the uninterrupted run gives (greedy and
keyed-sampled).  The two frameworks hash the same engine configuration
equal, and ``check_compatible`` refuses the same mismatches with the same
messages."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import transfer as jtransfer

from paddle_tpu_torch.serving import ServingEngine, transfer
from paddle_tpu_torch.serving.transfer import RunTransferError

from torch_parity import tiny_pair

ENGINE = dict(max_slots=2, max_len=48, prefill_buckets=(8, 16),
              decode_chunk=2, block_size=8)
PROMPT = [5, 17, 3, 99, 42, 7]
SAMPLED = dict(decode_strategy="sampling", temperature=0.8, top_k=5,
               top_p=0.9, seed=21)


@pytest.fixture(scope="module")
def engines():
    """Port and reference engines of one tiny GPT, each in both layouts."""
    jm, tm = tiny_pair(seed=1)
    out = {}
    for kv in ("fixed", "paged"):
        out["port", kv] = ServingEngine(tm, kv=kv, device="cpu", **ENGINE)
        out["ref", kv] = JEngine(jm, kv=kv, **ENGINE)
        out["port", kv].warmup()
        out["ref", kv].warmup()
    return out


def _uninterrupted(eng, kw):
    r = eng.submit(PROMPT, 16, **kw)
    eng.run_until_drained(timeout=120)
    return r.tokens()


def _preempted(eng, kw):
    """Run a request four steps in, preempt it: (tokens so far, run)."""
    req, resp = eng.make_request(PROMPT, 16, **kw)
    assert eng.try_admit(req, resp)
    for _ in range(3):
        eng.step()
    (slot,) = list(eng._slots)
    return resp.tokens_so_far(), eng.preempt_slot(slot)


def test_config_hash_is_the_reference_one(engines):
    ours = {kv: transfer.engine_config_hash(engines["port", kv])
            for kv in ("fixed", "paged")}
    theirs = {kv: jtransfer.engine_config_hash(engines["ref", kv])
              for kv in ("fixed", "paged")}
    assert ours == theirs and ours["fixed"] == ours["paged"]
    assert (transfer.target_manifest(engines["port", "paged"])
            == jtransfer.target_manifest(engines["ref", "paged"]))


@pytest.mark.parametrize("kw", [{}, SAMPLED], ids=["greedy", "sampled"])
@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_a_run_crosses_the_wire_and_continues_its_stream(engines, kw,
                                                         direction):
    src_fw, dst_fw = (("port", "ref") if direction == "port_to_ref"
                      else ("ref", "port"))
    src = engines[src_fw, "paged"]
    dst = engines[dst_fw, "fixed"]
    encode = (transfer if src_fw == "port" else jtransfer)
    decode = (transfer if dst_fw == "port" else jtransfer)
    whole = _uninterrupted(engines["ref", "fixed"], kw)
    head, paused = _preempted(src, kw)
    assert paused.source_config_hash == encode.engine_config_hash(src)
    data = encode.run_to_bytes(encode.encode_run(paused))
    blob = decode.run_from_bytes(data)
    resumed = decode.decode_run(blob, engine=dst)
    assert resumed.source_config_hash == paused.source_config_hash
    assert resumed.req.seed == paused.req.seed
    assert dst.restore_run(resumed)
    dst.run_until_drained(timeout=120)
    assert head + resumed.resp.tokens() == whole
    assert len(whole) == 16
    if dst_fw == "port":
        assert isinstance(resumed.kv_rows[0][0], torch.Tensor)


def _blob(engines):
    _, paused = _preempted(engines["port", "paged"], {})
    return transfer.encode_run(paused)


def _mutations():
    def version(b):
        b["version"] = 1

    def config_hash(b):
        b["manifest"]["config_hash"] = "0123456789abcdef"

    def layers(b):
        b["kv_rows"] = b["kv_rows"][:1]

    def shape(b):
        k, v = b["kv_rows"][0]
        b["kv_rows"][0] = (k[:, :, :8], v)

    def dtype(b):
        k, v = b["kv_rows"][0]
        b["kv_rows"][0] = (k.astype(np.float64), v)

    def budget(b):
        b["req"]["max_new_tokens"] = 60

    return [version, config_hash, layers, shape, dtype, budget]


@pytest.mark.parametrize("mutate", _mutations(),
                         ids=lambda f: f.__name__)
def test_check_compatible_refuses_as_the_reference(engines, mutate):
    blob = _blob(engines)
    mutate(blob)
    with pytest.raises(RunTransferError) as ours:
        transfer.check_compatible(blob, engines["port", "fixed"])
    with pytest.raises(jtransfer.RunTransferError) as theirs:
        jtransfer.check_compatible(blob, engines["ref", "fixed"])
    assert str(ours.value) == str(theirs.value)
    engines["port", "paged"].run_until_drained(timeout=60)


def test_wire_form_keys_request_fields_and_bad_headers(engines):
    eng = engines["port", "fixed"]
    req, resp = eng.make_request(PROMPT, 8, tenant="t1", session="s9",
                                 resubmit=True)
    assert eng.try_admit(req, resp)
    eng.step()
    (slot,) = list(eng._slots)
    blob = transfer.encode_run(eng.preempt_slot(slot), engine=eng)
    data = transfer.run_to_bytes(blob)
    with np.load(__import__("io").BytesIO(data)) as z:
        assert sorted(z.files) == ["header", "k0", "k1", "key", "prompt",
                                   "v0", "v1"]
        assert z["k0"].dtype == np.float32 and z["key"].dtype == np.uint32
    back = transfer.decode_run(transfer.run_from_bytes(data))
    assert (back.req.tenant, back.req.session, back.req.resubmit) == (
        "t1", "s9", True)
    assert back.req.priority == 0 and back.req.adapter is None
    assert blob["manifest"]["kv_dtypes"][0] == ("float32", "float32")
    bad = dict(blob, version=3)
    for fw in (transfer, jtransfer):
        with pytest.raises(fw.RunTransferError, match="version"):
            fw.run_from_bytes(transfer.run_to_bytes(bad))
    resp.cancel()


def test_a_kv_dtype_override_hashes_apart_across_frameworks():
    """Deviation: the reference hashes ``str()`` of its JAX dtype object,
    the port a numpy dtype name; with no override (the default) the two
    hash equal (test above)."""
    jm, tm = tiny_pair(seed=2)
    ours = ServingEngine(tm, device="cpu", dtype=torch.float32, **ENGINE)
    theirs = JEngine(jm, dtype=jnp.float32, **ENGINE)
    assert (transfer.engine_config_hash(ours)
            != jtransfer.engine_config_hash(theirs))
    plain = ServingEngine(tm, device="cpu", **ENGINE)
    assert (transfer.engine_config_hash(ours)
            != transfer.engine_config_hash(plain))
