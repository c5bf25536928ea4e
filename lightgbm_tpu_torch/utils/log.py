"""Logging with pluggable callback and levels Fatal/Warning/Info/Debug.

Role parity with the reference's include/LightGBM/utils/log.h:20-105 (Log class
with ResetLogLevel/ResetCallBack and CHECK macros), redesigned as a plain Python
module-level logger so bindings can reroute output.
"""
from __future__ import annotations

import sys
from enum import IntEnum
from typing import Callable, Optional


class LogLevel(IntEnum):
    FATAL = -1
    WARNING = 0
    INFO = 1
    DEBUG = 2


_level = LogLevel.INFO
_callback: Optional[Callable[[str], None]] = None


class LightGBMError(RuntimeError):
    """Raised by Log.fatal — mirrors the reference's std::runtime_error on Log::Fatal."""


def reset_log_level(level: LogLevel) -> None:
    global _level
    _level = level


def reset_callback(callback: Optional[Callable[[str], None]]) -> None:
    global _callback
    _callback = callback


def _write(level_str: str, msg: str) -> None:
    line = "[LightGBM-Torch] [%s] %s\n" % (level_str, msg)
    if _callback is not None:
        _callback(line)
    else:
        sys.stdout.write(line)
        sys.stdout.flush()


class Log:
    @staticmethod
    def debug(msg: str, *args) -> None:
        if _level >= LogLevel.DEBUG:
            _write("Debug", msg % args if args else msg)

    @staticmethod
    def info(msg: str, *args) -> None:
        if _level >= LogLevel.INFO:
            _write("Info", msg % args if args else msg)

    @staticmethod
    def warning(msg: str, *args) -> None:
        if _level >= LogLevel.WARNING:
            _write("Warning", msg % args if args else msg)

    @staticmethod
    def fatal(msg: str, *args) -> None:
        text = msg % args if args else msg
        _write("Fatal", text)
        raise LightGBMError(text)


def check(condition: bool, msg: str = "Check failed") -> None:
    if not condition:
        Log.fatal(msg)
