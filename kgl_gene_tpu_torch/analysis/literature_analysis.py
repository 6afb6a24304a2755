"""LITERATURE analysis: per-gene PubMed publication retrieval & ranking.

Capability parity with LiteratureAnalysis
(kga_analytic/kga_literature/kga_analysis_literature.h:28 + gene/
publication modules): per-gene PMID sets assembled from the citation /
bioPMID resources, publication details from the (cache-backed) PubMed
requester, ranked by citation count per gene.

Copy of kgl_gene_tpu/analysis/literature_analysis.py on the port's
literature/ modules; no device work.
"""

from __future__ import annotations

import os
from typing import Dict, List, Set

from ..app.analysis import VirtualAnalysis, register_analysis
from ..app.resources import AnalysisResources, ResourceType
from ..literature.publication import LiteratureAnalysis as PublicationMaps
from ..utils.logging import log

__all__ = ["LiteratureAnalysis"]


@register_analysis
class LiteratureAnalysis(VirtualAnalysis):
    ANALYSIS_IDENT = "LITERATURE"

    def __init__(self, device=None):
        super().__init__(device)
        self.work_directory = "."
        self.bio_pmid = None
        self.entrez = None
        self.pubmed = None
        self.gene_pmids: Dict[str, Set[str]] = {}

    def initialize_analysis(self, work_directory, parameters, resources) -> bool:
        self.work_directory = work_directory
        self.bio_pmid = resources.get_resource(ResourceType.BIO_PMID)
        self.entrez = resources.get_resource(ResourceType.ENTREZ)
        self.pubmed = resources.get_resource(ResourceType.PUBMED_API)
        gene_list: List[str] = []
        for block in parameters:
            genes = block.value("GeneList")
            if genes:
                gene_list = [g.strip() for g in genes.split(",") if g.strip()]
        self.gene_list = gene_list
        return True

    def file_read_analysis(self, data_object) -> bool:
        # Accumulate rsid citations if the file was a citation DB.
        citation_map = getattr(data_object, "citation_map", None)
        if citation_map is not None:
            for rsid, pmids in citation_map.items():
                self.gene_pmids.setdefault(rsid, set()).update(pmids)
        return True

    def finalize_analysis(self) -> bool:
        # Gene -> PMIDs via Entrez + bioPMID resources.
        if self.bio_pmid is not None and self.entrez is not None:
            for symbol in self.gene_list:
                entrez_id = self.entrez.entrez_id(symbol)
                if entrez_id:
                    pmids = self.bio_pmid.entrez_pmids(entrez_id)
                    if pmids:
                        self.gene_pmids.setdefault(symbol, set()).update(pmids)
        path = os.path.join(self.work_directory, "gene_literature.csv")
        all_publications: Dict[str, object] = {}
        with open(path, "w") as f:
            f.write("Gene,PMID,CitationCount,Title\n")
            for gene in sorted(self.gene_pmids):
                pmids = self.gene_pmids[gene]
                publications = (
                    self.pubmed.get_publications(pmids) if self.pubmed else {}
                )
                all_publications.update(publications)
                ranked = sorted(
                    pmids,
                    key=lambda p: publications[p].citation_count() if p in publications else 0,
                    reverse=True,
                )
                for pmid in ranked:
                    pub = publications.get(pmid)
                    cites = pub.citation_count() if pub else ""
                    title = pub.title.replace(",", ";") if pub else ""
                    f.write(f"{gene},{pmid},{cites},{title}\n")
        if all_publications:
            self._write_publication_maps(all_publications)
        log().info("LITERATURE: {} genes/alleles with publications", len(self.gene_pmids))
        return True

    def _write_publication_maps(self, publications) -> None:
        """The PublicationLiterature analysis-map reports
        (kga_analysis_literature_publication.h:18-35): author / year /
        journal maps, citation period, histogram, and quantiles."""
        maps = PublicationMaps(publications)

        def write(name: str, header: str, rows) -> None:
            with open(os.path.join(self.work_directory, name), "w") as f:
                f.write(header + "\n")
                for row in rows:
                    f.write(",".join(str(x) for x in row) + "\n")

        write(
            "literature_authors.csv", "Author,Publications,TotalCitations",
            sorted(
                ((author, len(pubs), sum(p.citation_count() for p in pubs))
                 for author, pubs in maps.by_author().items()),
                key=lambda r: -r[2],
            ),
        )
        write(
            "literature_years.csv", "Year,Publications,TotalCitations",
            sorted(
                (year, len(pubs), sum(p.citation_count() for p in pubs))
                for year, pubs in maps.by_year().items()
            ),
        )
        write(
            "literature_journals.csv", "Journal,Publications,TotalCitations",
            sorted(
                ((j.replace(",", ";"), len(pubs),
                  sum(p.citation_count() for p in pubs))
                 for j, pubs in maps.by_journal().items()),
                key=lambda r: -r[1],
            ),
        )
        write(
            "literature_citation_period.csv", "MonthsAfterPublication,Citations",
            maps.citation_period().items(),
        )
        write(
            "literature_citation_histogram.csv", "CitationCount,Publications",
            maps.citation_distribution(months_elapsed=0),
        )
        quartiles = maps.citation_quartiles(months_elapsed=0)
        rows = []
        for fraction in (0.25, 0.5, 0.75, 0.9, 0.95):
            element = quartiles.percentile(fraction)
            if element is not None:
                value, pub = element
                rows.append((fraction, int(value), pub.pmid if pub else ""))
        write("literature_citation_quartiles.csv", "Fraction,Citations,PMID", rows)
