"""Application runtime environment.

Capability parity with ExecEnv / GeneExecEnv
(kel_app/kel_exec_env.h:23, kel_exec_env_app.h:90-146,
kgl_app/kgl_gene_app.h:33-70, kgl_main.cpp:9-17): command line parsing
(work dir, options XML, log file, warn/error caps, verbosity), logger
creation, SIGINT handling, the run-level wall/CPU report, and the
runApplication[AppEnv] template as run_application(app_class, argv).

Copy of kgl_gene_tpu/app/exec_env.py with two changes: no compilation
cache is set up (the port compiles nothing at run time but its kernels,
built once into the package), and --device names where the analyses run
(the card by default; "cpu" runs the same path on the CPU). The device
goes to ExecutePackage, which hands it to every analysis. Run it as

    python -m kgl_gene_tpu_torch.app.exec_env --optionFile runtime.xml \
        --workDirectory work/ [--device cpu]
"""

from __future__ import annotations

import argparse
import signal
import sys
from typing import List, Optional, Type

from ..utils.logging import ExecEnvLogger, init_logger, log
from ..utils.utility import process_mem_usage
from .package import ExecutePackage
from .runtime import RuntimeProperties

__all__ = ["CmdLineArgs", "GeneExecEnv", "run_application"]


class CmdLineArgs:
    def __init__(self):
        self.work_directory = "."
        self.option_file = ""
        self.log_file = ""
        self.max_error_count = 1000
        self.max_warn_count = 1000
        self.verbose = False
        self.device: Optional[str] = None

    @classmethod
    def parse(cls, argv: List[str]) -> "CmdLineArgs":
        parser = argparse.ArgumentParser(
            prog="kgl_gene_tpu_torch",
            description="Population genomics analysis on an NVIDIA GPU (KGL_Gene capability set)",
        )
        parser.add_argument("--workDirectory", "-d", default=".",
                            help="directory for all output files")
        parser.add_argument("--optionFile", "-e", default="",
                            help="runtime definition XML")
        parser.add_argument("--logFile", "-l", default="",
                            help="log file (within work directory)")
        parser.add_argument("--errorCount", type=int, default=1000,
                            help="abort after this many errors")
        parser.add_argument("--warnCount", type=int, default=1000,
                            help="mute warnings after this many")
        parser.add_argument("--verbose", "-v", action="store_true")
        parser.add_argument("--device", default=None,
                            help="where the analyses run: cuda (the default) or cpu")
        ns = parser.parse_args(argv)
        args = cls()
        args.work_directory = ns.workDirectory
        args.option_file = ns.optionFile
        args.log_file = ns.logFile
        args.max_error_count = ns.errorCount
        args.max_warn_count = ns.warnCount
        args.verbose = ns.verbose
        args.device = ns.device
        return args


class GeneExecEnv:
    """The main application environment (GeneExecEnv)."""

    VERSION = "0.1.0"
    MODULE_NAME = "kgl_gene_tpu_torch"

    def __init__(self):
        self.args: Optional[CmdLineArgs] = None
        self.runtime: Optional[RuntimeProperties] = None
        self.executor: Optional[ExecutePackage] = None

    def parse_command_line(self, argv: List[str]) -> bool:
        self.args = CmdLineArgs.parse(argv)
        return True

    def create_logger(self) -> ExecEnvLogger:
        import os

        log_path = None
        if self.args and self.args.log_file:
            log_path = os.path.join(self.args.work_directory, self.args.log_file)
            os.makedirs(self.args.work_directory, exist_ok=True)
        return init_logger(
            module=self.MODULE_NAME,
            max_warnings=self.args.max_warn_count if self.args else 1000,
            max_errors=self.args.max_error_count if self.args else 1000,
            log_file=log_path,
            verbose=self.args.verbose if self.args else False,
        )

    def execute_app(self) -> None:
        if not self.args or not self.args.option_file:
            log().info("no option file given; nothing to execute")
            return
        # Importing the registration module populates the static factory
        # map (the reference registers plugins in a static map at link time,
        # kga_analytic/kga_analysis_factory.cpp:31-41; in Python the import
        # is the registration step). It is not analysis/__init__, which
        # ops/traceback imports on its way to analysis/legacy.
        from ..analysis import registered  # noqa: F401
        self.runtime = RuntimeProperties.read_properties(self.args.option_file)
        if self.args.work_directory != ".":
            self.runtime.work_directory = self.args.work_directory
        self.executor = ExecutePackage(self.runtime, device=self.args.device)
        self.executor.execute_active()


def run_application(app_class: Type[GeneExecEnv], argv: Optional[List[str]] = None) -> int:
    """ExecEnv::runApplication — parse args, build logger, install SIGINT,
    run, report wall/CPU/memory at exit (kel_exec_env_app.h:90-146)."""
    argv = sys.argv[1:] if argv is None else argv
    app = app_class()
    if not app.parse_command_line(argv):
        return 1
    logger = app.create_logger()
    logger.info("{} {} begins", app.MODULE_NAME, app.VERSION)

    def _sigint(signum, frame):
        logger.warn("interrupt received; terminating")
        raise SystemExit(130)

    previous = signal.signal(signal.SIGINT, _sigint)
    try:
        app.execute_app()
    except SystemExit:
        raise
    except Exception as exc:  # noqa: BLE001 — terminal catch-all, as in the reference
        logger.error("uncaught exception terminates run: {}", exc)
        return 1
    finally:
        signal.signal(signal.SIGINT, previous)
        vm, rss = process_mem_usage()
        logger.info("process memory; vm: {:.1f} MB, rss: {:.1f} MB", vm, rss)
        logger.run_report()
    return 0


def main() -> int:
    return run_application(GeneExecEnv)


if __name__ == "__main__":
    raise SystemExit(main())
