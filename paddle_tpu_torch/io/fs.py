"""Filesystem clients (counterpart of paddle_tpu/io/fs.py): ``LocalFS``
and ``HDFSClient`` behind one ``FS`` interface, and ``get_fs`` to pick
one by the path's scheme.

Host-side services use them (dataset file lists, checkpoint uploads); the
device path never does.  ``HDFSClient`` shells out to the ``hadoop``
command line as Paddle's does: its constructor raises ``ExecuteError``
when that command is not on the host, and every call retries
``retry_times`` times with a ``time_out`` (ms) per attempt.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import time
from typing import List, Optional, Sequence, Tuple

__all__ = [
    "FS", "LocalFS", "HDFSClient", "get_fs", "ExecuteError",
    "FSFileExistsError", "FSFileNotExistsError", "FSTimeOut",
]


class ExecuteError(Exception):
    pass


class FSFileExistsError(Exception):
    pass


class FSFileNotExistsError(Exception):
    pass


class FSTimeOut(Exception):
    pass


class FS:
    """The filesystem interface; LocalFS and HDFSClient implement it."""

    def ls_dir(self, fs_path) -> Tuple[List[str], List[str]]:
        """-> (dirs, files) directly under fs_path."""
        raise NotImplementedError

    def is_file(self, fs_path) -> bool:
        raise NotImplementedError

    def is_dir(self, fs_path) -> bool:
        raise NotImplementedError

    def is_exist(self, fs_path) -> bool:
        raise NotImplementedError

    def upload(self, local_path, fs_path):
        raise NotImplementedError

    def download(self, fs_path, local_path):
        raise NotImplementedError

    def mkdirs(self, fs_path):
        raise NotImplementedError

    def delete(self, fs_path):
        raise NotImplementedError

    def need_upload_download(self) -> bool:
        raise NotImplementedError

    def rename(self, fs_src_path, fs_dst_path):
        raise NotImplementedError

    def mv(self, fs_src_path, fs_dst_path, overwrite=False,
           test_exists=False):
        raise NotImplementedError

    def list_dirs(self, fs_path) -> List[str]:
        dirs, _ = self.ls_dir(fs_path)
        return dirs

    def list_files(self, fs_path) -> List[str]:
        _, files = self.ls_dir(fs_path)
        return files

    def touch(self, fs_path, exist_ok=True):
        raise NotImplementedError


class LocalFS(FS):
    """The local filesystem behind the FS interface."""

    def ls_dir(self, fs_path):
        if not self.is_exist(fs_path):
            return [], []
        dirs, files = [], []
        for name in sorted(os.listdir(fs_path)):
            if os.path.isdir(os.path.join(fs_path, name)):
                dirs.append(name)
            else:
                files.append(name)
        return dirs, files

    def is_file(self, fs_path):
        return os.path.isfile(fs_path)

    def is_dir(self, fs_path):
        return os.path.isdir(fs_path)

    def is_exist(self, fs_path):
        return os.path.exists(fs_path)

    def mkdirs(self, fs_path):
        os.makedirs(fs_path, exist_ok=True)

    def delete(self, fs_path):
        if os.path.isdir(fs_path):
            shutil.rmtree(fs_path, ignore_errors=True)
        elif os.path.exists(fs_path):
            os.remove(fs_path)

    def need_upload_download(self):
        return False

    def upload(self, local_path, fs_path):
        # local to local is a copy
        if os.path.isdir(local_path):
            shutil.copytree(local_path, fs_path)
        else:
            shutil.copy2(local_path, fs_path)

    download = upload

    def rename(self, fs_src_path, fs_dst_path):
        os.rename(fs_src_path, fs_dst_path)

    def mv(self, src_path, dst_path, overwrite=False, test_exists=False):
        if test_exists:
            if not self.is_exist(src_path):
                raise FSFileNotExistsError(src_path)
            if not overwrite and self.is_exist(dst_path):
                raise FSFileExistsError(dst_path)
        if overwrite and self.is_exist(dst_path):
            self.delete(dst_path)
        os.rename(src_path, dst_path)

    def touch(self, fs_path, exist_ok=True):
        if self.is_exist(fs_path):
            if not exist_ok:
                raise FSFileExistsError(fs_path)
            return
        d = os.path.dirname(fs_path)
        if d:
            self.mkdirs(d)
        open(fs_path, "a").close()


def _hadoop_available(cmd: str) -> bool:
    return shutil.which(cmd.split()[0]) is not None


class HDFSClient(FS):
    """The ``hadoop fs`` command-line client.  ``configs`` (for example
    fs.default.name, hadoop.job.ugi) go to every call as -D options; each
    call retries ``retry_times`` times, ``time_out`` ms per attempt,
    ``sleep_inter`` ms apart."""

    def __init__(self, hadoop_home: Optional[str] = None,
                 configs: Optional[dict] = None, time_out: int = 5 * 60 * 1000,
                 sleep_inter: int = 1000, retry_times: int = 3):
        if hadoop_home:
            self._cmd = os.path.join(hadoop_home, "bin", "hadoop")
        else:
            self._cmd = "hadoop"
        self._opts: List[str] = []
        for k, v in (configs or {}).items():
            self._opts += ["-D", f"{k}={v}"]
        self._timeout_s = max(1, time_out // 1000)
        self._sleep_s = max(0.0, sleep_inter / 1000.0)
        self._retries = max(1, retry_times)
        if not _hadoop_available(self._cmd):
            raise ExecuteError(
                f"hadoop binary not found ({self._cmd}); HDFSClient needs a "
                "Hadoop install on the host")

    # -- shell plumbing ---------------------------------------------------
    def _run(self, *args: str, check: bool = True) -> Tuple[int, str]:
        cmd = [self._cmd, "fs"] + self._opts + list(args)
        last = None
        for attempt in range(self._retries):
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=self._timeout_s)
            except subprocess.TimeoutExpired as e:
                last = FSTimeOut(f"{' '.join(cmd)} timed out: {e}")
                time.sleep(self._sleep_s)
                continue
            if proc.returncode == 0 or not check:
                return proc.returncode, proc.stdout
            last = ExecuteError(
                f"{' '.join(cmd)} rc={proc.returncode}: "
                f"{proc.stderr[-500:]}")
            time.sleep(self._sleep_s)
        raise last  # type: ignore[misc]

    # -- FS interface -----------------------------------------------------
    def ls_dir(self, fs_path):
        rc, out = self._run("-ls", fs_path, check=False)
        if rc != 0:
            return [], []
        dirs, files = [], []
        for line in out.splitlines():
            fields = line.split()
            if len(fields) < 8:
                continue
            name = os.path.basename(fields[-1])
            (dirs if fields[0].startswith("d") else files).append(name)
        return dirs, files

    def _test(self, flag: str, fs_path) -> bool:
        rc, _ = self._run("-test", flag, fs_path, check=False)
        return rc == 0

    def is_file(self, fs_path):
        return self._test("-f", fs_path)

    def is_dir(self, fs_path):
        return self._test("-d", fs_path)

    def is_exist(self, fs_path):
        return self._test("-e", fs_path)

    def upload(self, local_path, fs_path):
        if not os.path.exists(local_path):
            raise FSFileNotExistsError(local_path)
        self._run("-put", local_path, fs_path)

    def download(self, fs_path, local_path):
        if not self.is_exist(fs_path):
            raise FSFileNotExistsError(fs_path)
        self._run("-get", fs_path, local_path)

    def mkdirs(self, fs_path):
        self._run("-mkdir", "-p", fs_path)

    def delete(self, fs_path):
        if self.is_exist(fs_path):
            self._run("-rm", "-r", "-skipTrash", fs_path)

    def need_upload_download(self):
        return True

    def rename(self, fs_src_path, fs_dst_path):
        self._run("-mv", fs_src_path, fs_dst_path)

    def mv(self, fs_src_path, fs_dst_path, overwrite=False,
           test_exists=False):
        if test_exists:
            if not self.is_exist(fs_src_path):
                raise FSFileNotExistsError(fs_src_path)
            if not overwrite and self.is_exist(fs_dst_path):
                raise FSFileExistsError(fs_dst_path)
        if overwrite and self.is_exist(fs_dst_path):
            self.delete(fs_dst_path)
        self._run("-mv", fs_src_path, fs_dst_path)

    def touch(self, fs_path, exist_ok=True):
        if self.is_exist(fs_path):
            if not exist_ok:
                raise FSFileExistsError(fs_path)
            return
        self._run("-touchz", fs_path)


def get_fs(path: str) -> FS:
    """HDFSClient for hdfs:// and afs:// paths, else LocalFS."""
    if path.startswith(("hdfs://", "afs://")):
        return HDFSClient()
    return LocalFS()
