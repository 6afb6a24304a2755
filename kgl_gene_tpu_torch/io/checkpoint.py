"""Ingest checkpoint / resume.

The reference has no checkpointing (runs re-execute from XML; SURVEY.md
section 5) — the only adjacent mechanisms are the PubMed disk cache and
precomputed similarity matrices. The failure-recovery equivalent here is
a *deterministic ingest cursor*: record (file, line number, counts,
content fingerprint) as parsing proceeds so an interrupted ingest resumes
by skipping already-processed records and re-verifying the prefix
fingerprint, plus whole-population columnar snapshots (save/load) so
analyses restart from the parsed state instead of the raw VCF.

Copy of kgl_gene_tpu/io/checkpoint.py with one difference: snapshots are
read by a restricted unpickler (load_snapshot) that admits builtins,
numpy, collections and this package's own classes only. A snapshot that
names any other class (one written by another package, say) raises
UnusableCheckpoint, which the VCF ingest treats like an unreadable cursor:
a warning and a fresh ingest.
"""

from __future__ import annotations

import json
import os
import pickle
from dataclasses import asdict, dataclass
from typing import Optional

from ..utils.logging import log
from ..utils.string_hash import combine_hash, string_hash

__all__ = ["IngestCursor", "UnusableCheckpoint", "load_population", "load_snapshot",
           "save_population"]

# Top-level modules whose classes a snapshot may name. A pickle names the
# module a class was defined in, so numpy's arrays and dtypes come from
# numpy.* and numpy's private core modules; builtins covers the containers.
_ADMITTED_ROOTS = ("builtins", "numpy", "collections", "kgl_gene_tpu_torch")


class UnusableCheckpoint(Exception):
    """A snapshot that cannot be read back by this package."""


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        root = module.split(".")[0]
        if root not in _ADMITTED_ROOTS:
            raise UnusableCheckpoint(f"snapshot names {module}.{name}, outside this package")
        return super().find_class(module, name)


def load_snapshot(path: str):
    """Unpickle `path` admitting builtins, numpy, collections and
    kgl_gene_tpu_torch classes only; UnusableCheckpoint on anything else
    or on a damaged file."""
    with open(path, "rb") as f:
        try:
            return _RestrictedUnpickler(f).load()
        except UnusableCheckpoint:
            raise
        except (pickle.UnpicklingError, EOFError, AttributeError, ImportError,
                IndexError, TypeError, ValueError) as exc:
            raise UnusableCheckpoint(f"snapshot {path} unreadable: {exc}") from exc


@dataclass
class IngestCursor:
    """Resumable position in a VCF ingest."""

    file_path: str
    line_number: int = 0
    record_count: int = 0
    variant_count: int = 0
    fingerprint: int = 0  # rolling hash of processed record keys

    def advance(self, record_key: str, variants_added: int) -> None:
        self.line_number += 1
        self.record_count += 1
        self.variant_count += variants_added
        self.fingerprint = combine_hash(self.fingerprint, string_hash(record_key))

    # --- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(asdict(self), f)

    @classmethod
    def load(cls, path: str) -> Optional["IngestCursor"]:
        if not os.path.isfile(path):
            return None
        try:
            with open(path) as f:
                return cls(**json.load(f))
        except (json.JSONDecodeError, TypeError):
            log().warn("ingest cursor {} unreadable; restarting ingest", path)
            return None

    def should_skip(self, line_number: int) -> bool:
        """True while replaying the already-processed prefix."""
        return line_number <= self.line_number


def save_population(population, path: str) -> None:
    """Columnar population snapshot (pickle of the arena + incidence
    columns); restores in O(load) instead of re-parsing the VCF."""
    state = {
        "population_id": population.population_id,
        "data_source": population.data_source,
        "arena": population.arena,
        "genomes": {
            gid: {
                cid: contig.columns()
                for cid, contig in genome.contig_map.items()
            }
            for gid, genome in population.genome_map.items()
        },
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)  # atomic publish


def load_population(path: str):
    """The population of a save_population snapshot; UnusableCheckpoint
    when the snapshot names a class outside this package."""
    from ..variant.db import ContigDB, PopulationDB

    state = load_snapshot(path)
    population = PopulationDB(
        state["population_id"], state["data_source"], state["arena"]
    )
    for gid, contigs in state["genomes"].items():
        genome = population.get_create_genome(gid)
        for cid, cols in contigs.items():
            contig = ContigDB(cid, population.arena)
            contig = contig._from_columns(cols)
            genome.contig_map[cid] = contig
    return population
