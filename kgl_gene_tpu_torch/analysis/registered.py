"""The registration of the nine analyses in the factory map: importing
this module imports the seven analysis files, whose @register_analysis
decorators fill kgl_gene_tpu_torch.app.analysis's registry
(kga_analysis_factory.cpp:31-41 analogue; kgl_gene_tpu registers them in
analysis/__init__).

It is a module of its own, which app/exec_env imports at run time, and not
analysis/__init__: ops/traceback imports analysis/legacy through that
package, and lib_seqmutation, which sequence_analysis imports, imports
ops/traceback, so registering in __init__ would import ops/traceback while
it is half initialised.
"""

from .inbreed_analysis import InbreedAnalysis
from .info_analysis import InfoFilterAnalysis, IntervalAnalysis, JsonAnalysis
from .literature_analysis import LiteratureAnalysis
from .mutation_analysis import MutationAnalysis
from .null_analysis import NullAnalysis
from .pfemp_analysis import PfEMPAnalysis
from .sequence_analysis import SequenceAnalysis

__all__ = ["InbreedAnalysis", "InfoFilterAnalysis", "IntervalAnalysis", "JsonAnalysis",
           "LiteratureAnalysis", "MutationAnalysis", "NullAnalysis", "PfEMPAnalysis",
           "SequenceAnalysis"]
