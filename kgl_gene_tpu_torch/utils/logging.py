"""Run-time logger with severity caps.

Capability parity with the reference's ExecEnvLogger
(kel_app/kel_logging.h:74, kel_logging_stream.h:27): INFO/WARN/ERROR/
CRITICAL severities, configurable max warning/error counts after which
messages are muted (warnings) or the run aborts (errors), ANSI colour on
stdout plus an optional plain file sink, and message counting for the
end-of-run report. Implemented over the stdlib logging module rather than a
bespoke stream stack.

Copy of kgl_gene_tpu/utils/logging.py; the default logger is named after this package.
"""

from __future__ import annotations

import logging
import sys
import time
from typing import Optional

__all__ = ["ExecEnvLogger", "log", "init_logger"]

_ANSI = {
    "INFO": "\033[32m",
    "WARNING": "\033[33m",
    "ERROR": "\033[31m",
    "CRITICAL": "\033[1;31m",
}
_RESET = "\033[0m"


class _ColourFormatter(logging.Formatter):
    def format(self, record):
        base = super().format(record)
        colour = _ANSI.get(record.levelname)
        if colour and sys.stdout.isatty():
            return f"{colour}{base}{_RESET}"
        return base


class ExecEnvLogger:
    """Severity-capped logger. ``critical`` raises SystemExit after logging."""

    def __init__(
        self,
        module: str = "kgl_gene_tpu_torch",
        max_warnings: int = 100,
        max_errors: int = 100,
        log_file: Optional[str] = None,
        verbose: bool = False,
    ):
        self.module = module
        self.max_warnings = max_warnings
        self.max_errors = max_errors
        self.warn_count = 0
        self.error_count = 0
        self._start_wall = time.time()
        self._start_cpu = time.process_time()

        self._logger = logging.getLogger(module)
        self._logger.setLevel(logging.DEBUG if verbose else logging.INFO)
        self._logger.handlers.clear()
        self._logger.propagate = False
        fmt = "%(asctime)s %(levelname)s [%(name)s] %(message)s"
        stream = logging.StreamHandler(sys.stdout)
        stream.setFormatter(_ColourFormatter(fmt))
        self._logger.addHandler(stream)
        if log_file:
            fh = logging.FileHandler(log_file)
            fh.setFormatter(logging.Formatter(fmt))
            self._logger.addHandler(fh)

    # --- severity API (format-string style like the reference) -----------
    def info(self, msg: str, *args) -> None:
        self._logger.info(msg.format(*args) if args else msg)

    def warn(self, msg: str, *args) -> None:
        self.warn_count += 1
        if self.max_warnings and self.warn_count > self.max_warnings:
            if self.warn_count == self.max_warnings + 1:
                self._logger.warning(
                    "maximum warnings reached ({}); further warnings muted".format(
                        self.max_warnings
                    )
                )
            return
        self._logger.warning(msg.format(*args) if args else msg)

    def error(self, msg: str, *args) -> None:
        self.error_count += 1
        self._logger.error(msg.format(*args) if args else msg)
        if self.max_errors and self.error_count > self.max_errors:
            self.critical("maximum errors reached ({}); aborting", self.max_errors)

    def critical(self, msg: str, *args) -> None:
        self._logger.critical(msg.format(*args) if args else msg)
        raise SystemExit(1)

    # --- run accounting (kel_exec_env_app.h:120-126) ----------------------
    def elapsed(self) -> tuple[float, float]:
        """(wall seconds, process CPU seconds) since logger creation."""
        return time.time() - self._start_wall, time.process_time() - self._start_cpu

    def run_report(self) -> None:
        wall, cpu = self.elapsed()
        self.info(
            "run complete; wall: {:.2f}s, cpu: {:.2f}s, warnings: {}, errors: {}",
            wall,
            cpu,
            self.warn_count,
            self.error_count,
        )


_GLOBAL: Optional[ExecEnvLogger] = None


def init_logger(**kwargs) -> ExecEnvLogger:
    global _GLOBAL
    _GLOBAL = ExecEnvLogger(**kwargs)
    return _GLOBAL


def log() -> ExecEnvLogger:
    """Global logger accessor (ExecEnv::log() analogue)."""
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = ExecEnvLogger()
    return _GLOBAL
