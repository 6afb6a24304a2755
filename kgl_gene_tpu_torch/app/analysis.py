"""Analysis plugin framework: the 4-phase lifecycle + factory registry.

Capability parity with VirtualAnalysis / PackageAnalysis
(kgl_app/kgl_package_analysis_virtual.h:20-56, kgl_package_analysis.h:24,
kga_analytic/kga_analysis_factory.cpp:31-41): plugins register by ident,
are instantiated per package, and receive initialize / file-read /
iteration / finalize calls; a plugin that returns False is dropped from
further processing.

Copy of kgl_gene_tpu/app/analysis.py with the device made explicit: the
factory hands each analysis the device its package runs on (the card
unless the command line asked for the CPU), and PackageAnalysis records
each analysis it drops, with the phase, in `dropped`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Type

from ..utils.logging import log
from .resources import AnalysisResources
from .runtime import ParameterMap

__all__ = ["VirtualAnalysis", "register_analysis", "analysis_factory", "PackageAnalysis"]


class VirtualAnalysis:
    """Base analysis plugin. Subclasses set ANALYSIS_IDENT and override the
    four lifecycle methods. `device` is where the analysis runs its device
    work (a torch.device, or None for the card)."""

    ANALYSIS_IDENT = "VIRTUAL"

    def __init__(self, device=None):
        self.device = device

    def initialize_analysis(self, work_directory: str,
                            parameters: List[ParameterMap],
                            resources: AnalysisResources) -> bool:
        """Called once before data files are processed."""
        return True

    def file_read_analysis(self, data_object) -> bool:
        """Called after each data file is parsed (DataDB equivalent:
        PopulationDB or other parsed file object)."""
        return True

    def iteration_analysis(self) -> bool:
        """Called at the end of each iterative file list."""
        return True

    def finalize_analysis(self) -> bool:
        """Called when all files have been processed; write outputs."""
        return True


_REGISTRY: Dict[str, Type[VirtualAnalysis]] = {}


def register_analysis(cls: Type[VirtualAnalysis]) -> Type[VirtualAnalysis]:
    """Class decorator: register in the static factory map."""
    _REGISTRY[cls.ANALYSIS_IDENT] = cls
    return cls


def analysis_factory(ident: str, device=None) -> Optional[VirtualAnalysis]:
    cls = _REGISTRY.get(ident)
    return cls(device=device) if cls else None


def registered_analysis_idents() -> List[str]:
    return sorted(_REGISTRY)


class PackageAnalysis:
    """Drives the active analyses of one package through the lifecycle,
    dropping any that fail (PackageAnalysis, kgl_package_analysis.cpp)."""

    def __init__(self, work_directory: str, runtime_properties, device=None):
        self.work_directory = work_directory
        self.runtime = runtime_properties
        self.device = device
        self._active: List[VirtualAnalysis] = []
        self.dropped: List[Tuple[str, str]] = []  # (analysis ident, phase)

    @property
    def active(self) -> List[VirtualAnalysis]:
        return list(self._active)

    def initialize(self, analysis_idents: List[str], resources: AnalysisResources) -> None:
        self._active = []
        for ident in analysis_idents:
            analysis = analysis_factory(ident, self.device)
            if analysis is None:
                log().error("analysis ident '{}' not registered; available: {}",
                            ident, ", ".join(registered_analysis_idents()))
                self.dropped.append((ident, "factory"))
                continue
            parameters = self.runtime.analysis_parameters(ident) if self.runtime else []
            if analysis.initialize_analysis(self.work_directory, parameters, resources):
                self._active.append(analysis)
            else:
                log().warn("analysis {} failed to initialize; dropped", ident)
                self.dropped.append((ident, "initialize_analysis"))

    def _apply(self, method: str, *args) -> None:
        kept = []
        for analysis in self._active:
            try:
                ok = getattr(analysis, method)(*args)
            except Exception as exc:  # noqa: BLE001 — plugin isolation
                log().error("analysis {} raised in {}: {}",
                            analysis.ANALYSIS_IDENT, method, exc)
                ok = False
            if ok:
                kept.append(analysis)
            else:
                log().warn("analysis {} failed {}; dropped",
                           analysis.ANALYSIS_IDENT, method)
                self.dropped.append((analysis.ANALYSIS_IDENT, method))
        self._active = kept

    def file_read_analysis(self, data_object) -> None:
        self._apply("file_read_analysis", data_object)

    def iteration_analysis(self) -> None:
        self._apply("iteration_analysis")

    def finalize_analysis(self) -> None:
        self._apply("finalize_analysis")
