"""MUTATION analysis: per-gene population statistics for human cohorts.

Capability parity with MutationAnalysis / GenomeMutation / GeneMutation
(kga_analytic/kga_mutation/kga_analysis_mutation.h:27,
kga_analysis_mutation_gene.h:32,66) and its companion modules:

  * GeneClinvar (kga_analysis_mutation_gene_clinvar.h:31, .cpp:90-160):
    a Clinvar population (MONO_GENOME ingest of the Clinvar VCF) is held
    aside when it arrives; per gene, its CLNSIG~PATHOGENIC alleles inside
    the gene span are intersected with the cohort by allele identity,
    yielding carrier/homozygous genome counts, an ethnic/sex breakdown of
    the carriers and the '&'-joined CLNDN clinical descriptions.
  * GeneEthnicitySex (kga_analysis_mutation_gene_ethnic.h:26): per gene,
    variant-carrying genome counts split male/female (genealogy PED
    resource) and by super-population (genome-aux resource).
  * GenerateGeneAllele (kga_analysis_mutation_gene_allele.h:19): one row
    per allele in a gene span — rs identifier, AC/AN/AF overall and per
    super-population, citation count from the allele-citation resource —
    written to gene_allele.csv.

All reductions are vectorized over the variant-major zygosity matrix; no
per-variant Python objects are materialised on the cohort path.

Copy of kgl_gene_tpu/analysis/mutation_analysis.py; host reductions
only (its ontology resource is the port's OntologyDatabase).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..app.analysis import VirtualAnalysis, register_analysis
from ..app.resources import AnalysisResources, ResourceType
from ..utils.logging import log
from ..variant.columnar import VariantMajorView

__all__ = ["MutationAnalysis"]

SUPER_POPS = ("AFR", "AMR", "EAS", "EUR", "SAS")
CLINVAR_CLNSIG_FIELD = "CLNSIG"
CLINVAR_CLNDN_FIELD = "CLNDN"
CLINVAR_PATH_SIGNIF = "PATHOGENIC"
CONCAT_TOKEN = "&"


def _info_text(value) -> str:
    if value is None:
        return ""
    if isinstance(value, (list, tuple)):
        return "|".join(str(v) for v in value if v is not None)
    return str(value)


def _is_clinvar(population) -> bool:
    source = f"{getattr(population, 'data_source', '')} {population.population_id}"
    return "CLINVAR" in source.upper()


@register_analysis
class MutationAnalysis(VirtualAnalysis):
    ANALYSIS_IDENT = "MUTATION"

    def __init__(self, device=None):
        super().__init__(device)
        self.work_directory = "."
        self.genome_reference = None
        self.genome_aux = None
        self.genealogy = None
        self.citations = None
        self.ontology = None
        self.clinvar_population = None
        self._cohorts: List[object] = []
        self.rows: List[str] = []
        self.allele_rows: List[str] = []

    def initialize_analysis(self, work_directory, parameters, resources) -> bool:
        self.work_directory = work_directory
        self.genome_reference = resources.get_resource(ResourceType.GENOME_DATABASE)
        self.genome_aux = resources.get_resource(ResourceType.GENOME_AUX)
        self.genealogy = resources.get_resource(ResourceType.GENEALOGY)
        self.citations = resources.get_resource(ResourceType.CITATION)
        self.ontology = resources.get_resource(ResourceType.ONTOLOGY_DATABASE)
        if self.genome_reference is None:
            log().error("MUTATION requires a GenomeDatabase resource")
            return False
        return True

    # ------------------------------------------------------------------ #
    def _super_pop_of(self, genome_id: str) -> str:
        if self.genome_aux is not None:
            sp = self.genome_aux.super_population_of(genome_id)
            if sp:
                return sp
        if self.genealogy is not None:
            rec = self.genealogy.get(genome_id)
            if rec and rec.population:
                return rec.population
        return "UNKNOWN"

    def _sex_of(self, genome_id: str) -> str:
        """'M' / 'F' / '' from the genealogy PED record (sex 1=male,
        2=female; kgl_hsgenealogy_parser.h sexType)."""
        if self.genealogy is None:
            return ""
        rec = self.genealogy.get(genome_id)
        if rec is None:
            return ""
        sex = (rec.sex or "").strip().upper()
        if sex in ("1", "M", "MALE"):
            return "M"
        if sex in ("2", "F", "FEMALE"):
            return "F"
        return ""

    # ------------------------------------------------------------------ #
    def _clinvar_pathogenic(self) -> Tuple[Set[str], Dict[str, str]]:
        """(pathogenic allele HGVS set, hgvs -> CLNDN description)."""
        pathogenic: Set[str] = set()
        descriptions: Dict[str, str] = {}
        population = self.clinvar_population
        if population is None:
            return pathogenic, descriptions
        info = getattr(population, "info_store", None)
        for _, genome in population:
            for _, contig in genome:
                for variant in contig:
                    clnsig = ""
                    clndn = ""
                    if info is not None and variant.info_index >= 0:
                        if info.has_field(CLINVAR_CLNSIG_FIELD):
                            clnsig = _info_text(
                                info.value(CLINVAR_CLNSIG_FIELD, variant.info_index)
                            )
                        if info.has_field(CLINVAR_CLNDN_FIELD):
                            clndn = _info_text(
                                info.value(CLINVAR_CLNDN_FIELD, variant.info_index)
                            )
                    if CLINVAR_PATH_SIGNIF in clnsig.upper():
                        key = variant.hgvs()
                        pathogenic.add(key)
                        if clndn:
                            descriptions[key] = clndn
        return pathogenic, descriptions

    # ------------------------------------------------------------------ #
    def file_read_analysis(self, population) -> bool:
        if not hasattr(population, "genome_map"):
            return True  # not a variant population (e.g. citation file)
        if _is_clinvar(population):
            self.clinvar_population = population
            log().info("MUTATION: clinvar population {} held for intersection",
                       population.population_id)
            return True
        self._cohorts.append(population)
        return True

    def iteration_analysis(self) -> bool:
        # Deferred so a Clinvar file later in the same iteration list is
        # available for the cohorts read before it.
        for population in self._cohorts:
            self._analyze_cohort(population)
        self._cohorts = []
        return True

    # ------------------------------------------------------------------ #
    def _analyze_cohort(self, population) -> None:
        view = VariantMajorView(population)
        arena = population.arena
        snp_col = arena.is_snp_column()
        genome_ids = view.genome_ids
        genome_pops = np.array([self._super_pop_of(g) for g in genome_ids])
        genome_sex = np.array([self._sex_of(g) for g in genome_ids])
        pathogenic, descriptions = self._clinvar_pathogenic()

        snp_rows = snp_col[view.rows] if len(view.rows) else np.zeros(0, bool)
        an = view.allele_number()
        for contig_id, contig in self.genome_reference:
            contig_idx = None
            for i, name in enumerate(arena.contig_names):
                if name == contig_id:
                    contig_idx = i
                    break
            if contig_idx is None:
                continue
            in_contig = view.contig_index == contig_idx
            offsets = view.offsets
            for gene in contig.all_genes():
                span = gene.interval
                in_gene = in_contig & (offsets >= span.lower) & (offsets < span.upper)
                if not in_gene.any():
                    continue
                self._gene_row(
                    gene, contig, contig_id, view, in_gene, snp_rows,
                    genome_pops, genome_sex, pathogenic, descriptions,
                )
                self._allele_rows(
                    gene, contig_id, view, in_gene, snp_rows, genome_pops,
                    an, arena,
                )

    def _gene_row(self, gene, contig, contig_id, view, in_gene, snp_rows,
                  genome_pops, genome_sex, pathogenic, descriptions) -> None:
        span = gene.interval
        offsets = view.offsets
        gene_variants = int(in_gene.sum())
        gene_snp = int((in_gene & snp_rows).sum())
        exon_mask = np.zeros_like(in_gene)
        for tx in contig.gene_transcripts(gene.feature_id).transcripts():
            for seg in tx.segments:
                exon_mask |= (offsets >= seg.interval.lower) & (
                    offsets < seg.interval.upper
                )
        exon_variants = int((in_gene & exon_mask).sum())

        sub = view.zygosity[:, in_gene]  # (G, v_gene)
        # Ethnic/sex genome-carrier splits (GeneEthnicitySex::genomeAnalysis).
        carrier = sub.sum(axis=1) > 0
        hom_carrier = (sub == 2).any(axis=1)
        carriers_total = int(carrier.sum())
        male = int((carrier & (genome_sex == "M")).sum())
        female = int((carrier & (genome_sex == "F")).sum())
        pop_counts = {}
        eth_carriers = {}
        for pop in SUPER_POPS + ("UNKNOWN",):
            rows = genome_pops == pop
            pop_counts[pop] = int(sub[rows].sum()) if rows.any() else 0
            eth_carriers[pop] = int((carrier & rows).sum()) if rows.any() else 0

        # Clinvar intersection (GeneClinvar::processClinvar): pathogenic
        # clinvar alleles inside the span, matched to cohort alleles.
        clin_alleles = 0
        clin_cols = np.zeros(int(in_gene.sum()), dtype=bool)
        clin_desc: List[str] = []
        if pathogenic:
            gene_hgvs = [view.hgvs[i] for i in np.nonzero(in_gene)[0]]
            for j, h in enumerate(gene_hgvs):
                if h in pathogenic:
                    clin_cols[j] = True
                    if h in descriptions:
                        clin_desc.append(descriptions[h])
            clin_alleles = int(clin_cols.sum())
        if clin_alleles:
            clin_sub = sub[:, clin_cols]
            clin_carrier = clin_sub.sum(axis=1) > 0
            clin_genomes = int(clin_carrier.sum())
            clin_hom = int((clin_sub == 2).any(axis=1).sum())
            clin_male = int((clin_carrier & (genome_sex == "M")).sum())
            clin_female = int((clin_carrier & (genome_sex == "F")).sum())
        else:
            clin_genomes = clin_hom = clin_male = clin_female = 0

        go_terms = ""
        if self.genome_reference.gene_ontology:
            go_terms = "|".join(
                self.genome_reference.gene_ontology.get(gene.feature_id, [])
            )
        self.rows.append(
            ",".join(
                [
                    gene.feature_id, contig_id,
                    str(span.lower), str(span.upper),
                    str(gene_variants), str(gene_snp), str(exon_variants),
                    str(carriers_total), str(male), str(female),
                ]
                + [str(pop_counts[p]) for p in SUPER_POPS + ("UNKNOWN",)]
                + [str(eth_carriers[p]) for p in SUPER_POPS + ("UNKNOWN",)]
                + [
                    str(clin_alleles), str(clin_genomes), str(clin_hom),
                    str(clin_male), str(clin_female),
                    CONCAT_TOKEN.join(sorted(set(clin_desc))),
                ]
                + [go_terms]
            )
        )

    def _allele_rows(self, gene, contig_id, view, in_gene, snp_rows,
                     genome_pops, an, arena) -> None:
        """Per-allele population-frequency rows
        (GenerateGeneAllele::writeOutput)."""
        idx = np.nonzero(in_gene)[0]
        if idx.size == 0:
            return
        sub = view.zygosity[:, idx]  # (G, k)
        ac = sub.sum(axis=0).astype(np.int64)
        pop_ac = {
            pop: (sub[genome_pops == pop].sum(axis=0).astype(np.int64)
                  if (genome_pops == pop).any() else np.zeros(idx.size, np.int64))
            for pop in SUPER_POPS
        }
        for j, col in enumerate(idx):
            row = int(view.rows[col])
            rsid = arena.identifier(row)
            citation_count = (
                len(self.citations.pmids_for(rsid)) if (self.citations and rsid) else 0
            )
            from ..sequence.alphabet import DNA5

            ref = DNA5.to_string(arena.ref_codes(row))
            alt = DNA5.to_string(arena.alt_codes(row))
            af = ac[j] / an if an else 0.0
            self.allele_rows.append(
                ",".join(
                    [
                        gene.feature_id, contig_id, str(int(view.offsets[col])),
                        rsid, ref, alt,
                        "1" if snp_rows[col] else "0",
                        str(int(ac[j])), str(an), f"{af:.6g}",
                    ]
                    + [str(int(pop_ac[p][j])) for p in SUPER_POPS]
                    + [str(citation_count)]
                )
            )

    # ------------------------------------------------------------------ #
    def finalize_analysis(self) -> bool:
        path = os.path.join(self.work_directory, "gene_mutation.csv")
        header = (
            "Gene,Contig,Start,End,Variants,SNPs,ExonVariants,"
            "CarrierGenomes,MaleCarriers,FemaleCarriers,"
            + ",".join("AC_" + p for p in SUPER_POPS + ("UNKNOWN",))
            + ","
            + ",".join("ETH_" + p for p in SUPER_POPS + ("UNKNOWN",))
            + ",ClinvarAlleles,ClinvarGenomes,ClinvarHom,ClinvarMale,"
            "ClinvarFemale,ClinvarDesc,GOTerms"
        )
        with open(path, "w") as f:
            f.write(header + "\n")
            f.write("\n".join(self.rows) + ("\n" if self.rows else ""))
        allele_path = os.path.join(self.work_directory, "gene_allele.csv")
        allele_header = (
            "Gene,Contig,Offset,ID,Ref,Alt,SNP,AC,AN,AF,"
            + ",".join("AC_" + p for p in SUPER_POPS)
            + ",Citations"
        )
        with open(allele_path, "w") as f:
            f.write(allele_header + "\n")
            f.write("\n".join(self.allele_rows) + ("\n" if self.allele_rows else ""))
        log().info("MUTATION: {} gene rows, {} allele rows written",
                   len(self.rows), len(self.allele_rows))
        return True
