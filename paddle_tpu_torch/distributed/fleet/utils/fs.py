"""Filesystem abstraction: local + HDFS.

Counterpart of paddle_tpu/distributed/fleet/utils/fs.py (a copy: it
is pure Python): the `FS` interface with `LocalFS` and `HDFSClient`
(shelling out to `hadoop fs`), used by the checkpoint tier and
incubate's auto-checkpoint.
"""
from __future__ import annotations

import os
import shutil
import subprocess

__all__ = ["FS", "LocalFS", "HDFSClient", "FSFileExistsError",
           "FSFileNotExistsError"]


class FSFileExistsError(Exception):
    pass


class FSFileNotExistsError(Exception):
    pass


class FS:
    def ls_dir(self, fs_path):
        raise NotImplementedError

    def is_dir(self, fs_path):
        raise NotImplementedError

    def is_file(self, fs_path):
        raise NotImplementedError

    def is_exist(self, fs_path):
        raise NotImplementedError

    def upload(self, local_path, fs_path):
        raise NotImplementedError

    def download(self, fs_path, local_path):
        raise NotImplementedError

    def mkdirs(self, fs_path):
        raise NotImplementedError

    def delete(self, fs_path):
        raise NotImplementedError

    def mv(self, fs_src_path, fs_dst_path, overwrite=False):
        raise NotImplementedError

    def touch(self, fs_path, exist_ok=True):
        raise NotImplementedError


class LocalFS(FS):
    """fs.py LocalFS parity."""

    def ls_dir(self, fs_path):
        if not self.is_exist(fs_path):
            return [], []
        dirs, files = [], []
        for name in os.listdir(fs_path):
            if os.path.isdir(os.path.join(fs_path, name)):
                dirs.append(name)
            else:
                files.append(name)
        return dirs, files

    def is_dir(self, fs_path):
        return os.path.isdir(fs_path)

    def is_file(self, fs_path):
        return os.path.isfile(fs_path)

    def is_exist(self, fs_path):
        return os.path.exists(fs_path)

    def mkdirs(self, fs_path):
        os.makedirs(fs_path, exist_ok=True)

    def delete(self, fs_path):
        if os.path.isdir(fs_path):
            shutil.rmtree(fs_path, ignore_errors=True)
        elif os.path.exists(fs_path):
            os.remove(fs_path)

    def mv(self, src, dst, overwrite=False):
        if not os.path.exists(dst):
            # same-filesystem move is an atomic rename (the checkpoint
            # tier's commit primitive); cross-device falls back to copy
            shutil.move(src, dst)
            return
        if not overwrite:
            raise FSFileExistsError(dst)
        if os.path.isfile(src) and not os.path.isdir(dst):
            try:
                os.replace(src, dst)  # atomic file swap, never a window
                return
            except OSError:
                pass  # cross-device (EXDEV): no atomic swap exists
        self.delete(dst)
        shutil.move(src, dst)

    def touch(self, fs_path, exist_ok=True):
        if os.path.exists(fs_path):
            if not exist_ok:
                raise FSFileExistsError(fs_path)
            return
        open(fs_path, "a").close()

    def upload(self, local_path, fs_path):
        shutil.copy(local_path, fs_path)

    def download(self, fs_path, local_path):
        shutil.copy(fs_path, local_path)


class HDFSClient(FS):
    """fs.py HDFSClient parity: shells out to `hadoop fs` (io/fs.cc analog).
    All calls raise FSFileNotExistsError cleanly when the hadoop binary is
    unavailable, so auto-checkpoint degrades to LocalFS."""

    def __init__(self, hadoop_home=None, configs=None, time_out=5 * 60 * 1000,
                 sleep_inter=1000):
        self._hadoop = os.path.join(hadoop_home, "bin", "hadoop") \
            if hadoop_home else "hadoop"
        self._configs = configs or {}
        self._timeout = time_out / 1000.0

    def _run(self, *args):
        cmd = [self._hadoop, "fs"]
        for k, v in self._configs.items():
            cmd += ["-D", f"{k}={v}"]
        cmd += list(args)
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=self._timeout)
        except (FileNotFoundError, subprocess.TimeoutExpired) as e:
            raise FSFileNotExistsError(f"hadoop unavailable: {e}")
        return out

    def is_exist(self, fs_path):
        return self._run("-test", "-e", fs_path).returncode == 0

    def is_dir(self, fs_path):
        return self._run("-test", "-d", fs_path).returncode == 0

    def is_file(self, fs_path):
        return self.is_exist(fs_path) and not self.is_dir(fs_path)

    def ls_dir(self, fs_path):
        out = self._run("-ls", fs_path)
        dirs, files = [], []
        for line in out.stdout.splitlines():
            parts = line.split()
            if len(parts) < 8:
                continue
            name = os.path.basename(parts[-1])
            (dirs if parts[0].startswith("d") else files).append(name)
        return dirs, files

    def mkdirs(self, fs_path):
        self._run("-mkdir", "-p", fs_path)

    def delete(self, fs_path):
        self._run("-rm", "-r", "-f", fs_path)

    def mv(self, src, dst, overwrite=False):
        if overwrite:
            self.delete(dst)
        elif self.is_exist(dst):
            raise FSFileExistsError(dst)
        self._run("-mv", src, dst)

    def touch(self, fs_path, exist_ok=True):
        self._run("-touchz", fs_path)

    def upload(self, local_path, fs_path):
        self._run("-put", "-f", local_path, fs_path)

    def download(self, fs_path, local_path):
        self._run("-get", fs_path, local_path)
