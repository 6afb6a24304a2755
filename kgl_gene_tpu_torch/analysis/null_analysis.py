"""NULL analysis: lifecycle template / smoke test
(kga_analytic/kga_template_analysis/kga_analysis_null.h:16).

Copy of kgl_gene_tpu/analysis/null_analysis.py; no device work.
"""

from __future__ import annotations

from typing import List

from ..app.analysis import VirtualAnalysis, register_analysis
from ..app.resources import AnalysisResources
from ..app.runtime import ParameterMap
from ..utils.logging import log

__all__ = ["NullAnalysis"]


@register_analysis
class NullAnalysis(VirtualAnalysis):
    """Documents the 4-phase lifecycle; logs each call."""

    ANALYSIS_IDENT = "NULL"

    def __init__(self, device=None):
        super().__init__(device)
        self.work_directory = ""
        self.file_count = 0
        self.iteration_count = 0
        self.finalized = False

    def initialize_analysis(self, work_directory: str,
                            parameters: List[ParameterMap],
                            resources: AnalysisResources) -> bool:
        self.work_directory = work_directory
        log().info("NullAnalysis initialized; work directory: {}", work_directory)
        return True

    def file_read_analysis(self, data_object) -> bool:
        self.file_count += 1
        log().info("NullAnalysis file read #{}: {}", self.file_count,
                   getattr(data_object, "population_id", type(data_object).__name__))
        return True

    def iteration_analysis(self) -> bool:
        self.iteration_count += 1
        log().info("NullAnalysis iteration #{}", self.iteration_count)
        return True

    def finalize_analysis(self) -> bool:
        self.finalized = True
        log().info("NullAnalysis finalized; {} files, {} iterations",
                   self.file_count, self.iteration_count)
        return True
