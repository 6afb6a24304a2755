"""Publication model and literature analysis maps.

Capability parity with PublicationSummary and the literature analysis
containers (kgl_literature/kgl_literature.h:40, kgl_literature_analysis.h):
authors, journal/volume/issue, abstract, MeSH codes, chemical codes,
citation sets, and the derived analysis maps (by author, by year, by
journal, citation counts).

Copy of kgl_gene_tpu/literature/publication.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["PublicationSummary", "LiteratureAnalysis"]


@dataclass
class PublicationSummary:
    pmid: str
    publication_date: str = ""  # YYYY-MM-DD or YYYY-MM
    journal: str = ""
    journal_issue: str = ""
    journal_volume: str = ""
    doi: str = ""
    title: str = ""
    abstract: str = ""
    authors: List[Tuple[str, str]] = field(default_factory=list)  # (surname, initials)
    chemicals: List[Tuple[str, str]] = field(default_factory=list)  # (MeSH code, description)
    mesh_codes: List[Tuple[str, str]] = field(default_factory=list)  # (MeSH code, description)
    cited_by: Set[str] = field(default_factory=set)  # pmids citing this one

    def citation_count(self) -> int:
        return len(self.cited_by)

    def publication_year(self) -> Optional[int]:
        if self.publication_date[:4].isdigit():
            return int(self.publication_date[:4])
        return None

    def has_mesh_code(self, code: str) -> bool:
        return any(c == code for c, _ in self.mesh_codes)

    def author_string(self) -> str:
        return "; ".join(f"{surname} {initials}".strip() for surname, initials in self.authors)


class LiteratureAnalysis:
    """Derived maps over a publication collection
    (kgl_literature_analysis.h)."""

    def __init__(self, publications: Dict[str, PublicationSummary]):
        self.publications = publications

    def by_author(self) -> Dict[str, List[PublicationSummary]]:
        out: Dict[str, List[PublicationSummary]] = {}
        for pub in self.publications.values():
            for surname, initials in pub.authors:
                key = f"{surname}_{initials}".strip("_")
                out.setdefault(key, []).append(pub)
        return out

    def by_year(self) -> Dict[int, List[PublicationSummary]]:
        out: Dict[int, List[PublicationSummary]] = {}
        for pub in self.publications.values():
            year = pub.publication_year()
            if year is not None:
                out.setdefault(year, []).append(pub)
        return out

    def by_journal(self) -> Dict[str, List[PublicationSummary]]:
        out: Dict[str, List[PublicationSummary]] = {}
        for pub in self.publications.values():
            if pub.journal:
                out.setdefault(pub.journal, []).append(pub)
        return out

    def by_citation_count(self) -> List[PublicationSummary]:
        return sorted(
            self.publications.values(), key=lambda p: p.citation_count(), reverse=True
        )

    # --- citation-time analyses (kgl_literature_analysis.cpp:131-360) ------
    def most_recent_publication(self) -> Optional[PublicationSummary]:
        dated = [p for p in self.publications.values() if p.publication_date]
        return max(dated, key=lambda p: p.publication_date) if dated else None

    def _reference_date(self) -> str:
        """Download-date stand-in: the newest date in the collection."""
        latest = self.most_recent_publication()
        return latest.publication_date if latest else ""

    def citation_period(self) -> Dict[int, int]:
        """months-after-publication -> citation count, over citing pmids
        resolvable in this collection (analyseCitationPeriod)."""
        out: Dict[int, int] = {}
        for pub in self.publications.values():
            for cite_pmid in pub.cited_by:
                citing = self.publications.get(cite_pmid)
                if citing is None:
                    continue
                months = _months_between(pub.publication_date,
                                         citing.publication_date)
                if months is not None:
                    out[months] = out.get(months, 0) + 1
        return dict(sorted(out.items()))

    def citation_variance(self, max_period_months: int = 120
                          ) -> Dict[int, Tuple[float, float]]:
        """month -> (mean, variance) of the cumulative % of a publication's
        citations arrived by that month (analyseCitationPercent)."""
        per_pub: List[List[float]] = []
        for pub in self.publications.values():
            arrivals: Dict[int, int] = {}
            total = 0
            for cite_pmid in pub.cited_by:
                citing = self.publications.get(cite_pmid)
                if citing is None:
                    continue
                months = _months_between(pub.publication_date,
                                         citing.publication_date)
                if months is not None and months < max_period_months:
                    arrivals[months] = arrivals.get(months, 0) + 1
                    total += 1
            if total == 0:
                continue
            cum, acc = [], 0
            for m in range(max_period_months):
                acc += arrivals.get(m, 0)
                cum.append(100.0 * acc / total)
            per_pub.append(cum)
        out: Dict[int, Tuple[float, float]] = {}
        for m in range(max_period_months):
            vals = [c[m] for c in per_pub]
            if not vals:
                out[m] = (0.0, 0.0)
                continue
            mean = sum(vals) / len(vals)
            var = sum((v - mean) ** 2 for v in vals) / len(vals)
            out[m] = (mean, var)
        return out

    def _aged(self, months_elapsed: int) -> List[PublicationSummary]:
        ref = self._reference_date()
        return [
            p for p in self.publications.values()
            if (_months_between(p.publication_date, ref) or 0) >= months_elapsed
        ]

    def citation_quartiles(self, months_elapsed: int = 120):
        """Percentile over citation counts of sufficiently old publications
        (analyseCitationQuartiles)."""
        from ..utils.percentile import Percentile

        quantile = Percentile()
        for pub in self._aged(months_elapsed):
            quantile.add_element(pub.citation_count(), pub)
        return quantile

    def citation_distribution(self, months_elapsed: int = 120,
                              max_citation: int = 101
                              ) -> List[Tuple[int, int]]:
        """Histogram [(citation count, publications)] capped at max_citation
        (citationDistribution)."""
        histogram = [[c, 0] for c in range(max_citation + 1)]
        for pub in self._aged(months_elapsed):
            count = min(pub.citation_count(), max_citation)
            histogram[count][1] += 1
        return [tuple(h) for h in histogram]

    def publication_citations(self, pmid: str) -> List[Tuple[int, int]]:
        """Citation arrivals [(months after publication, count)] for one
        publication (publicationCitations)."""
        pub = self.publications.get(pmid)
        if pub is None:
            return []
        arrivals: Dict[int, int] = {}
        for cite_pmid in pub.cited_by:
            citing = self.publications.get(cite_pmid)
            if citing is None:
                continue
            months = _months_between(pub.publication_date, citing.publication_date)
            if months is not None:
                arrivals[months] = arrivals.get(months, 0) + 1
        return sorted(arrivals.items())


def _months_between(earlier: str, later: str) -> Optional[int]:
    """Whole-month difference between YYYY[-MM[-DD]] dates (DateGP::
    monthsDifference); None when either date is unparseable; clamped >= 0."""
    def parse(text: str) -> Optional[Tuple[int, int]]:
        if not text or not text[:4].isdigit():
            return None
        year = int(text[:4])
        month = 1
        if len(text) >= 7 and text[5:7].isdigit():
            month = max(1, min(12, int(text[5:7])))
        return year, month

    a, b = parse(earlier), parse(later)
    if a is None or b is None:
        return None
    return max(0, (b[0] - a[0]) * 12 + (b[1] - a[1]))
