"""Logging subsystem.

Equivalent of the reference HighsLogOptions / highsLogUser /
highsLogDev (highs/io/HighsIO.h:39-56, HighsIO.cpp): typed message
levels kInfo..kError, console + file targets, a user callback hook that
overrides both, developer levels gated by `log_dev_level`, and
`timeless_log` for reproducible output (times replaced by a fixed
token).
"""
from __future__ import annotations

import enum
import re
import sys
import time
from typing import Callable, Optional


class HighsLogType(enum.IntEnum):
    """Message types (reference HighsIO.h HighsLogType)."""
    kInfo = 1
    kDetailed = 2
    kVerbose = 3
    kWarning = 4
    kError = 5


_TIME_RE = re.compile(r"\b\d+\.\d{2}\b")


class HighsLogger:
    """Routes solver log lines per the option settings.

    Mirrors the reference semantics (HighsIO.cpp highsLogUser):
    - `output_flag` off silences everything;
    - a user callback, when set, receives every message (and console /
      file output still happens per their flags);
    - `log_dev_level` >= 1/2/3 enables kDetailed/kVerbose dev messages;
    - `timeless_log` scrubs wall-clock numbers for reproducible logs.
    """

    def __init__(self, options=None):
        self._options = options
        self._callback: Optional[Callable[[int, str], None]] = None
        self._file_handle = None
        self._file_path = ""

    def set_options(self, options):
        self._options = options

    def set_callback(self, cb: Optional[Callable[[int, str], None]]):
        self._callback = cb

    # -- option access with safe defaults --------------------------------
    def _opt(self, name, default):
        try:
            return getattr(self._options, name)
        except Exception:
            return default

    def _ensure_file(self):
        path = self._opt("log_file", "")
        if path != self._file_path:
            if self._file_handle is not None:
                try:
                    self._file_handle.close()
                except Exception:
                    pass
                self._file_handle = None
            self._file_path = path
            if path:
                try:
                    self._file_handle = open(path, "a")
                except OSError:
                    self._file_handle = None
        return self._file_handle

    def log(self, log_type: HighsLogType, msg: str):
        if not self._opt("output_flag", True):
            return
        if self._opt("timeless_log", False):
            msg = _TIME_RE.sub("t.tt", msg)
        if self._callback is not None:
            self._callback(int(log_type), msg)
        if self._opt("log_to_console", True):
            stream = sys.stderr if log_type >= HighsLogType.kWarning \
                else sys.stdout
            print(msg, file=stream)
        fh = self._ensure_file()
        if fh is not None:
            fh.write(msg + "\n")
            fh.flush()

    # -- user-level messages (highsLogUser) -------------------------------
    def info(self, msg: str):
        self.log(HighsLogType.kInfo, msg)

    def warning(self, msg: str):
        self.log(HighsLogType.kWarning, "WARNING: " + msg)

    def error(self, msg: str):
        self.log(HighsLogType.kError, "ERROR:   " + msg)

    # -- developer messages (highsLogDev, gated by log_dev_level) ---------
    def dev(self, level: int, msg: str):
        if self._opt("log_dev_level", 0) >= level:
            log_type = (HighsLogType.kInfo if level <= 1 else
                        HighsLogType.kDetailed if level == 2 else
                        HighsLogType.kVerbose)
            self.log(log_type, msg)

    def close(self):
        if self._file_handle is not None:
            try:
                self._file_handle.close()
            except Exception:
                pass
            self._file_handle = None
            self._file_path = ""
