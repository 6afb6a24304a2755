"""Genome reference: an organism's contig collection + factory.

Capability parity with GenomeReference / GenomeCollection
(kgl_genomics/kgl_genome/kgl_genome_genome.h:28,55, kgl_genome_collection.h).

Copy of kgl_gene_tpu/genome/genome.py.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

from ..sequence.tables import amino_translation_table
from ..utils.logging import log
from .contig import ContigReference
from .features import Feature

__all__ = ["GenomeReference", "GenomeCollection"]


class GenomeReference:
    """All contigs of one organism, plus gene ontology annotation (GAF)."""

    def __init__(self, genome_id: str):
        self.genome_id = genome_id
        self.contigs: Dict[str, ContigReference] = {}
        # gene id -> list of GO terms (from GAF), populated by attach_gaf.
        self.gene_ontology: Dict[str, List[str]] = {}

    # ------------------------------------------------------------------ #
    @classmethod
    def create_genome_database(
        cls,
        genome_id: str,
        fasta_file: str,
        gff_file: Optional[str] = None,
        gaf_file: Optional[str] = None,
        translation_table: str = "NCBI_TABLE_1",
        verify: bool = True,
    ) -> "GenomeReference":
        """Factory reading FASTA + GFF3 (+ GAF), assigning the amino
        translation table and verifying the feature hierarchy
        (GenomeReference::createGenomeDatabase, kgl_genome_genome.h:55)."""
        from ..io.fasta import read_fasta
        from ..io.gff3 import parse_gff3_into
        from ..io.gaf import read_gaf

        genome = cls(genome_id)
        table = amino_translation_table(translation_table)
        for contig_id, sequence in read_fasta(fasta_file):
            genome.add_contig(ContigReference(contig_id, sequence, table))
        if gff_file:
            parse_gff3_into(gff_file, genome)
            for contig in genome.contigs.values():
                contig.setup_features()
            if verify:
                genome.verify_features()
        if gaf_file:
            genome.gene_ontology = read_gaf(gaf_file)
        return genome

    # ------------------------------------------------------------------ #
    def add_contig(self, contig: ContigReference) -> bool:
        if contig.contig_id in self.contigs:
            log().warn("duplicate contig {} in genome {}", contig.contig_id, self.genome_id)
            return False
        self.contigs[contig.contig_id] = contig
        return True

    def get_contig(self, contig_id: str) -> Optional[ContigReference]:
        return self.contigs.get(contig_id)

    def contig_ids(self) -> List[str]:
        return list(self.contigs)

    def __iter__(self) -> Iterator[Tuple[str, ContigReference]]:
        return iter(self.contigs.items())

    def gene_count(self) -> int:
        return sum(c.gene_count() for c in self.contigs.values())

    def find_gene(self, gene_id: str) -> Optional[Tuple[ContigReference, Feature]]:
        for contig in self.contigs.values():
            gene = contig.get_gene(gene_id)
            if gene is not None:
                return contig, gene
        return None

    def verify_features(self) -> Tuple[int, int]:
        valid = invalid = 0
        for contig in self.contigs.values():
            v, i = contig.verify_features()
            valid += v
            invalid += i
        log().info(
            "genome {}: verified transcripts, valid: {}, invalid: {}",
            self.genome_id, valid, invalid,
        )
        return valid, invalid

    def equivalent(self, other: "GenomeReference") -> bool:
        """Genome comparison 'used for testing' (kgl_genome_genome.h:62)."""
        if set(self.contigs) != set(other.contigs):
            return False
        return all(c.equivalent(other.contigs[cid]) for cid, c in self.contigs.items())

    def __repr__(self):
        return f"GenomeReference({self.genome_id}, {len(self.contigs)} contigs)"


class GenomeCollection:
    """Map of genome id -> GenomeReference (kgl_genome_collection.h)."""

    def __init__(self):
        self._genomes: Dict[str, GenomeReference] = {}

    def add_genome(self, genome: GenomeReference) -> bool:
        if genome.genome_id in self._genomes:
            return False
        self._genomes[genome.genome_id] = genome
        return True

    def get_genome(self, genome_id: str) -> Optional[GenomeReference]:
        return self._genomes.get(genome_id)

    def __len__(self):
        return len(self._genomes)

    def __iter__(self):
        return iter(self._genomes.items())
