"""Gregorian date utility (kel_utility/kel_date_time.h DateGP parity):
parse "2020/1/1" and "2001-Feb-28" formats, day/month arithmetic for
genealogy/age analytics.

Copy of kgl_gene_tpu/utils/date_time.py.
"""

from __future__ import annotations

import datetime as _dt
from typing import Optional

__all__ = ["DateGP"]

_MONTHS = {m: i + 1 for i, m in enumerate(
    ["Jan", "Feb", "Mar", "Apr", "May", "Jun",
     "Jul", "Aug", "Sep", "Oct", "Nov", "Dec"]
)}
_MONTH_NAMES = {v: k for k, v in _MONTHS.items()}


class DateGP:
    """Immutable-ish date value; default-constructed = 1901-Jan-01
    ("not initialized" sentinel, as in the reference)."""

    __slots__ = ("_date",)

    def __init__(self, *args):
        if len(args) == 0:
            self._date = _dt.date(1901, 1, 1)
        elif len(args) == 1:
            self._date = self._parse(args[0])
        elif len(args) == 3:
            year, month, day = args
            self._date = _dt.date(int(year), int(month), int(day))
        else:
            raise TypeError("DateGP(), DateGP(text) or DateGP(y, m, d)")

    @staticmethod
    def _parse(text: str) -> _dt.date:
        for sep in ("/", "-"):
            if sep in text:
                parts = text.split(sep)
                if len(parts) != 3:
                    break
                year = int(parts[0])
                month_text = parts[1]
                month = _MONTHS.get(month_text[:3].capitalize()) if not month_text.isdigit() else int(month_text)
                if month is None:
                    raise ValueError(f"bad month in date: {text}")
                return _dt.date(year, month, int(parts[2]))
        raise ValueError(f"unparseable date: {text}")

    # --- accessors --------------------------------------------------------
    @property
    def year(self) -> int:
        return self._date.year

    @property
    def month(self) -> int:
        return self._date.month

    @property
    def day(self) -> int:
        return self._date.day

    def set_today(self) -> None:
        self._date = _dt.date.today()

    def set_utc_date(self) -> None:
        self._date = _dt.datetime.now(_dt.timezone.utc).date()

    def text(self) -> str:
        """YYYY-MMM-DD, e.g. 2020-Jan-01."""
        return f"{self.year:04d}-{_MONTH_NAMES[self.month]}-{self.day:02d}"

    def not_initialized(self) -> bool:
        return self == DateGP()

    # --- comparisons ------------------------------------------------------
    def __eq__(self, other):
        return isinstance(other, DateGP) and self._date == other._date

    def __lt__(self, other):
        return self._date < other._date

    def __hash__(self):
        return hash(self._date)

    def __repr__(self):
        return f"DateGP({self.text()})"

    # --- arithmetic -------------------------------------------------------
    @staticmethod
    def days_difference(date1: "DateGP", date2: "DateGP") -> int:
        return abs((date2._date - date1._date).days)

    @staticmethod
    def months_difference(date1: "DateGP", date2: "DateGP") -> int:
        lo, hi = sorted((date1._date, date2._date))
        return (hi.year - lo.year) * 12 + (hi.month - lo.month)
