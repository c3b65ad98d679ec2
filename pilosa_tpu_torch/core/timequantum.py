"""Time quantum views (reference time.go).

A time field fans each Set out to per-granularity views
(``standard_2017``, ``standard_201701``, …); a time Range unions the
minimal covering set of views between start and end.
"""

from __future__ import annotations

from datetime import datetime, timedelta

VALID_QUANTUMS = {"Y", "YM", "YMD", "YMDH", "M", "MD", "MDH", "D", "DH", "H", ""}

TIME_FORMAT = "%Y-%m-%dT%H:%M"  # reference TimeFormat (pilosa.go)


def parse_time_quantum(v: str) -> str:
    q = v.upper()
    if q not in VALID_QUANTUMS:
        raise ValueError(f"invalid time quantum: {v!r}")
    return q


def view_by_time_unit(name: str, t: datetime, unit: str) -> str:
    """reference viewByTimeUnit (time.go:83-96)."""
    if unit == "Y":
        return f"{name}_{t.strftime('%Y')}"
    if unit == "M":
        return f"{name}_{t.strftime('%Y%m')}"
    if unit == "D":
        return f"{name}_{t.strftime('%Y%m%d')}"
    if unit == "H":
        return f"{name}_{t.strftime('%Y%m%d%H')}"
    return ""


def views_by_time(name: str, t: datetime, quantum: str) -> list[str]:
    """reference viewsByTime (time.go:99-109)."""
    out = []
    for unit in quantum:
        v = view_by_time_unit(name, t, unit)
        if v:
            out.append(v)
    return out


def _add_months(t: datetime, months: int) -> datetime:
    """Go AddDate month arithmetic, including its normalization: a day
    that doesn't exist in the target month rolls forward (Jan 29 + 1
    month = Mar 1; Feb 29 + 1 year = Mar 1). The walker probes month/
    year boundaries from arbitrary mid-walk days, so overflow is a
    reachable case, not a corner."""
    import calendar

    month = t.month - 1 + months
    year = t.year + month // 12
    month = month % 12 + 1
    last = calendar.monthrange(year, month)[1]
    if t.day <= last:
        return t.replace(year=year, month=month)
    return t.replace(year=year, month=month, day=last) + timedelta(
        days=t.day - last
    )


def _next_year_gte(t: datetime, end: datetime) -> bool:
    nxt = _add_months(t, 12)
    return nxt.year == end.year or end > nxt


def _next_month_gte(t: datetime, end: datetime) -> bool:
    nxt = _add_months(t, 1)
    return (nxt.year, nxt.month) == (end.year, end.month) or end > nxt


def _next_day_gte(t: datetime, end: datetime) -> bool:
    nxt = t + timedelta(days=1)
    return (nxt.year, nxt.month, nxt.day) == (end.year, end.month, end.day) or end > nxt


def views_by_time_range(name: str, start: datetime, end: datetime, quantum: str) -> list[str]:
    """Minimal covering view set for [start, end) (reference
    viewsByTimeRange, time.go:111-184): walk up from small units to
    aligned boundaries, then down from the largest unit."""
    t = start
    has_year = "Y" in quantum
    has_month = "M" in quantum
    has_day = "D" in quantum
    has_hour = "H" in quantum
    results: list[str] = []

    # Walk up from smallest units to largest units.
    if has_hour or has_day or has_month:
        while t < end:
            if has_hour:
                if not _next_day_gte(t, end):
                    break
                elif t.hour != 0:
                    results.append(view_by_time_unit(name, t, "H"))
                    t = t + timedelta(hours=1)
                    continue
            if has_day:
                if not _next_month_gte(t, end):
                    break
                elif t.day != 1:
                    results.append(view_by_time_unit(name, t, "D"))
                    t = t + timedelta(days=1)
                    continue
            if has_month:
                if not _next_year_gte(t, end):
                    break
                elif t.month != 1:
                    results.append(view_by_time_unit(name, t, "M"))
                    t = _add_months(t, 1)
                    continue
            break

    # Walk back down from largest units to smallest units.
    while t < end:
        if has_year and _next_year_gte(t, end):
            results.append(view_by_time_unit(name, t, "Y"))
            t = _add_months(t, 12)  # Go AddDate(1,0,0): Feb 29 -> Mar 1
        elif has_month and _next_month_gte(t, end):
            results.append(view_by_time_unit(name, t, "M"))
            t = _add_months(t, 1)
        elif has_day and _next_day_gte(t, end):
            results.append(view_by_time_unit(name, t, "D"))
            t = t + timedelta(days=1)
        elif has_hour:
            results.append(view_by_time_unit(name, t, "H"))
            t = t + timedelta(hours=1)
        else:
            break

    return results
