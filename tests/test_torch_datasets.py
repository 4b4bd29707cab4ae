"""paddle_tpu_torch's datasets, fleet data generators and filesystem
clients against the JAX package on the CPU: the reference's
tests/test_dataset_engine.py and tests/test_io_services.py (its
filesystem part) and its MultiSlot protocol case, mirrored on the port,
with the two packages side by side where both run.

- ``global_shuffle`` at 1, 2 and 4 ranks: every rank's batches equal the
  reference's, element for element (both sort the rows into a canonical
  order first, so neither load order matters).
- ``local_shuffle`` permutes the load order: compared as a set, features
  following their labels.
Files are built in ``tmp_path``.
"""
import io
import os

import numpy as np
import pytest

import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.io import fs as jfs

import paddle_tpu_torch.distributed as tdist
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.io import fs as tfs


def _write_files(tmp_path, n_files=4, rows_per_file=25, dim=6):
    rng = np.random.RandomState(0)
    paths, all_labels = [], []
    for fi in range(n_files):
        p = tmp_path / f"part-{fi:05d}.txt"
        with open(p, "w") as f:
            for r in range(rows_per_file):
                label = fi * rows_per_file + r  # unique id as label
                feats = rng.rand(dim)
                f.write(f"{label}\t" + " ".join(f"{v:.6f}" for v in feats)
                        + "\n")
        paths.append(str(p))
        all_labels.extend(range(fi * rows_per_file,
                                (fi + 1) * rows_per_file))
    return paths, all_labels, dim


class FakeFleet:
    def __init__(self, idx, num):
        self._i, self._n = idx, num

    def worker_index(self):
        return self._i

    def worker_num(self):
        return self._n


def _loaded(mod, paths, dim, **kw):
    ds = mod.InMemoryDataset()
    ds.init(feature_dim=dim, **kw)
    ds.set_filelist(paths)
    ds.load_into_memory()
    return ds


def test_load_into_memory_and_iterate(tmp_path):
    paths, all_labels, dim = _write_files(tmp_path)
    ds = _loaded(tdist, paths, dim, batch_size=10, thread_num=3)
    assert ds.get_memory_data_size() == 100 and len(ds) == 10
    seen = []
    for feats, labels in ds:
        assert feats.shape[1] == dim and feats.dtype == np.float32
        assert labels.dtype == np.int64
        seen.extend(labels.tolist())
    assert seen == all_labels   # file-list order, every row once


@pytest.mark.parametrize("nranks", [1, 2, 4])
def test_global_shuffle_batches_equal_the_reference(tmp_path, nranks):
    paths, all_labels, dim = _write_files(tmp_path)
    shards = []
    for rank in range(nranks):
        got = []
        for mod in (jdist, tdist):
            ds = _loaded(mod, paths, dim, batch_size=8, thread_num=2)
            ds.global_shuffle(fleet=FakeFleet(rank, nranks), seed=13)
            got.append([(f.copy(), lab.copy()) for f, lab in ds])
            assert ds.get_shuffle_data_size() == 100 // nranks
        (ref, port) = got
        assert len(ref) == len(port)
        for (jf, jl), (tf, tl) in zip(ref, port):
            np.testing.assert_array_equal(tl, jl)
            np.testing.assert_array_equal(tf, jf)
        shards.append([x for _, lab in port for x in lab.tolist()])
    assert sorted(sum(shards, [])) == all_labels   # an exact partition
    assert shards[0] != sorted(shards[0])          # actually shuffled


def test_global_shuffle_partition_survives_any_load_order(tmp_path):
    """Ranks whose rows sit in different orders still partition exactly:
    the canonical sort comes first."""
    paths, all_labels, dim = _write_files(tmp_path)
    shards = []
    for rank in range(2):
        ds = _loaded(tdist, paths, dim, batch_size=100, thread_num=3)
        scram = np.random.RandomState(100 + rank).permutation(
            len(ds._labels))
        ds._feats, ds._labels = ds._feats[scram], ds._labels[scram]
        ds.global_shuffle(fleet=FakeFleet(rank, 2), seed=21)
        shards.append([x for _, lab in ds for x in lab.tolist()])
    assert sorted(shards[0] + shards[1]) == all_labels
    assert not set(shards[0]) & set(shards[1])


def test_global_shuffle_reads_the_process_group_without_a_fleet(
        tmp_path, monkeypatch):
    paths, _, dim = _write_files(tmp_path)
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    ds = _loaded(tdist, paths, dim, batch_size=100)
    ds.global_shuffle(seed=5)
    assert ds.get_shuffle_data_size() == 25


def test_local_shuffle_keeps_the_set_and_rows(tmp_path):
    paths, all_labels, dim = _write_files(tmp_path)
    ref = _loaded(jdist, paths, dim, batch_size=100)
    ref.local_shuffle(seed=7)
    jf, jl = next(iter(ref))
    ds = _loaded(tdist, paths, dim, batch_size=100)
    before = next(iter(ds))[1].tolist()
    ds.local_shuffle(seed=7)
    feats, labels = next(iter(ds))
    assert labels.tolist() != before
    assert sorted(labels.tolist()) == sorted(jl.tolist()) == all_labels
    lut = {lab: f for lab, f in zip(jl.tolist(), jf)}
    for lab, f in zip(labels.tolist(), feats):
        np.testing.assert_array_equal(f, lut[lab])


def test_release_and_errors(tmp_path):
    paths, _, dim = _write_files(tmp_path, n_files=1)
    ds = tdist.InMemoryDataset()
    ds.init(batch_size=4, feature_dim=dim)
    ds.set_filelist(paths)
    with pytest.raises(RuntimeError):
        ds.local_shuffle()
    ds.load_into_memory()
    ds.release_memory()
    assert ds.get_memory_data_size() == 0
    ds2 = tdist.InMemoryDataset()
    ds2.set_filelist(paths)
    with pytest.raises(ValueError, match="feature_dim"):
        ds2.load_into_memory()
    ds3 = tdist.InMemoryDataset()
    ds3.init(feature_dim=dim)
    with pytest.raises(ValueError, match="set_filelist"):
        ds3.load_into_memory()


def test_malformed_lines_are_skipped_as_the_reference(tmp_path):
    """A line of another width, or whose label does not parse, is skipped,
    as the reference's Python parser skips it (its native feed, which the
    port does not have, reads a bad label otherwise).  A line whose
    values do not parse is skipped whole: the reference's parser keeps
    its label (its labels then outnumber its rows), the port does not."""
    from paddle_tpu.distributed.dataset import _parse_text_py
    p = tmp_path / "bad.txt"
    good = "1\t0.5 0.25\n2\t1,2\nx\t1 2\n3\t1 2 3\n4\t3.5 4.5\n"
    p.write_text(good)
    want_f, want_l = _parse_text_py(str(p), 2)
    feats, labels = next(iter(_loaded(tdist, [str(p)], 2, batch_size=10)))
    np.testing.assert_array_equal(labels, [1, 2, 4])
    np.testing.assert_array_equal(labels, want_l)
    np.testing.assert_array_equal(feats, want_f)
    p.write_text(good + "5\t1 y\n6\t7 8\n")
    ref_f, ref_l = _parse_text_py(str(p), 2)
    assert len(ref_l) == len(ref_f) + 1
    feats, labels = next(iter(_loaded(tdist, [str(p)], 2, batch_size=10)))
    np.testing.assert_array_equal(labels, [1, 2, 4, 6])
    np.testing.assert_array_equal(feats[-1], [7.0, 8.0])


def test_binary_records(tmp_path):
    rng = np.random.RandomState(0)
    feats = rng.rand(30, 5).astype("float32")
    labels = np.arange(30, dtype="int64")
    rec = np.dtype([("label", "<i8"), ("feat", "<f4", (5,))])
    data = np.empty(30, rec)
    data["label"], data["feat"] = labels, feats
    path = str(tmp_path / "part.bin")
    data.tofile(path)
    ds = _loaded(tdist, [path], 5, batch_size=8, binary=True)
    assert ds.get_memory_data_size() == 30
    got_f, got_l = next(iter(ds))
    np.testing.assert_array_equal(got_f, feats[:8])
    np.testing.assert_array_equal(got_l, labels[:8])


@pytest.mark.parametrize("drop_last", [False, True])
def test_queue_dataset_streams_all_rows(tmp_path, drop_last):
    paths, all_labels, dim = _write_files(tmp_path)
    ds = tdist.QueueDataset()
    ds.init(batch_size=7, thread_num=2, feature_dim=dim, drop_last=drop_last)
    ds.set_filelist(paths)
    seen = []
    for feats, labels in ds:
        assert feats.shape[0] == labels.shape[0] <= 7
        assert not drop_last or len(labels) == 7
        seen.extend(labels.tolist())
    assert seen == all_labels[:len(seen)]
    assert len(seen) == (98 if drop_last else 100)
    again = [x for _, lab in ds for x in lab.tolist()]   # files reopened
    assert again == seen


# ---------------------------------------------------------- data generators

def test_multislot_data_generators_protocol():
    outs = []
    for fleet in (jfleet, tfleet):
        class MyData(fleet.MultiSlotStringDataGenerator):
            def generate_sample(self, line):
                def local_iter():
                    yield [("words", line.split()), ("label", ["1"])]
                return local_iter

        class Typed(fleet.MultiSlotDataGenerator):
            def generate_sample(self, line):
                def local_iter():
                    yield [("ids", [int(x) for x in line.split()]),
                           ("w", [0.5])]
                return local_iter
        out, out2 = io.StringIO(), io.StringIO()
        MyData()._run_lines(["1926 08 17\n"], out)
        t = Typed()
        t.set_batch(2)
        t._run_lines(["1 2\n", "3\n", "4 5 6\n"], out2)
        outs.append((out.getvalue(), out2.getvalue()))
    assert outs[1] == outs[0]
    assert outs[1][0] == "3 1926 08 17 1 1\n"
    assert outs[1][1] == "2 1 2 1 0.5\n1 3 1 0.5\n3 4 5 6 1 0.5\n"


def test_data_generator_batches_and_refusals(monkeypatch):
    class Pairs(tfleet.MultiSlotDataGenerator):
        def generate_sample(self, line):
            def local_iter():
                if line is None:
                    for i in range(3):
                        yield [("a", [i])]
                elif line.strip():
                    yield [("a", [int(line)])]
                else:
                    yield None
            return local_iter

        def generate_batch(self, samples):
            def local_iter():
                yield [("n", [len(samples)])]
            return local_iter
    g = Pairs()
    g.set_batch(2)
    out = io.StringIO()
    g._run_lines(["1\n", "\n", "2\n", "3\n"], out)
    assert out.getvalue() == "1 2\n1 1\n"
    monkeypatch.setattr("sys.stdin", io.StringIO("7\n8\n"))
    monkeypatch.setattr("sys.stdout", out2 := io.StringIO())
    g.run_from_stdin()
    g.run_from_memory()
    assert out2.getvalue() == "1 2\n1 2\n1 1\n"
    with pytest.raises(NotImplementedError):
        tfleet.DataGenerator().generate_sample("x")
    with pytest.raises(ValueError):
        tfleet.MultiSlotDataGenerator()._gen_str("not a list")


# ------------------------------------------------------------ filesystems

class TestLocalFS:
    def test_roundtrip(self, tmp_path):
        fs = tfs.LocalFS()
        root = str(tmp_path / "a")
        fs.mkdirs(root)
        assert fs.is_dir(root) and fs.is_exist(root)
        f = os.path.join(root, "x.txt")
        fs.touch(f)
        assert fs.is_file(f)
        fs.touch(f, exist_ok=True)
        with pytest.raises(tfs.FSFileExistsError):
            fs.touch(f, exist_ok=False)
        fs.mkdirs(os.path.join(root, "sub"))
        assert fs.ls_dir(root) == jfs.LocalFS().ls_dir(root) == \
            (["sub"], ["x.txt"])
        assert fs.list_dirs(root) == ["sub"] and fs.list_files(root) == \
            ["x.txt"]
        assert fs.ls_dir(str(tmp_path / "none")) == ([], [])
        assert not fs.need_upload_download()
        copy = str(tmp_path / "copy")
        fs.upload(root, copy)
        assert fs.is_file(os.path.join(copy, "x.txt"))

    def test_mv_delete(self, tmp_path):
        fs = tfs.LocalFS()
        src = str(tmp_path / "src.bin")
        dst = str(tmp_path / "dst.bin")
        with open(src, "wb") as f:
            f.write(b"hello")
        fs.mv(src, dst)
        assert not fs.is_exist(src) and fs.is_file(dst)
        with pytest.raises(tfs.FSFileNotExistsError):
            fs.mv(str(tmp_path / "nope"), dst, test_exists=True)
        open(src, "wb").close()
        with pytest.raises(tfs.FSFileExistsError):
            fs.mv(src, dst, overwrite=False, test_exists=True)
        fs.mv(src, dst, overwrite=True)
        fs.rename(dst, src)
        fs.delete(src)
        assert not fs.is_exist(src)
        fs.delete(src)  # idempotent

    def test_get_fs_scheme(self):
        assert isinstance(tfs.get_fs("/tmp/x"), tfs.LocalFS)
        if os.path.exists("/usr/bin/hadoop"):
            assert isinstance(tfs.get_fs("hdfs://x"), tfs.HDFSClient)
        else:
            with pytest.raises(tfs.ExecuteError):
                tfs.get_fs("hdfs://x")

    def test_hdfs_gated(self):
        with pytest.raises(tfs.ExecuteError):
            tfs.HDFSClient(hadoop_home="/nonexistent-hadoop")

    def test_hdfs_client_runs_the_hadoop_command(self, tmp_path):
        """A stand-in ``hadoop`` script: the client passes -D options and
        its arguments, parses ``-ls`` and maps ``-test``'s exit codes."""
        bin_dir = tmp_path / "bin"
        bin_dir.mkdir()
        log = tmp_path / "calls.txt"
        script = bin_dir / "hadoop"
        script.write_text(
            "#!/bin/sh\n"
            f'echo "$@" >> {log}\n'
            'case "$*" in\n'
            '  *-ls*) echo "drwxr-xr-x - u g 0 2026-01-01 00:00 /d/sub";'
            ' echo "-rw-r--r-- 3 u g 5 2026-01-01 00:00 /d/f.txt";;\n'
            '  *"-test -e /missing"*) exit 1;;\n'
            'esac\n'
            'exit 0\n')
        script.chmod(0o755)
        fs = tfs.HDFSClient(str(tmp_path), {"fs.default.name": "hdfs://nn"},
                            time_out=5000, sleep_inter=0, retry_times=1)
        assert fs.ls_dir("/d") == (["sub"], ["f.txt"])
        assert fs.is_exist("/d") and not fs.is_exist("/missing")
        fs.mkdirs("/d/new")
        assert fs.need_upload_download()
        calls = log.read_text().splitlines()
        assert calls[0] == "fs -D fs.default.name=hdfs://nn -ls /d"
        assert "fs -D fs.default.name=hdfs://nn -mkdir -p /d/new" in calls
        with pytest.raises(tfs.FSFileNotExistsError):
            fs.download("/missing", str(tmp_path / "x"))
