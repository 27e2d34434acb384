"""Time-zone transition tables — a copy of ``spark_rapids_tpu/tzdb.py``
(numpy and the standard library only), the port's GpuTimeZoneDB analog.

TZif files (RFC 8536) are parsed from the system's zoneinfo directory into
two sorted int64 arrays per zone:

  * ``utc_instants`` / ``offsets``: the offset in effect at a UTC instant
    (from_utc_timestamp), found by a search on the instant;
  * ``wall_starts`` / ``offsets``: the offset chosen for a LOCAL wall time
    (to_utc_timestamp), each boundary at t_i + max(off_before,
    off_after), which reproduces java.time's gap (shift forward) and
    overlap (earlier offset) resolution, the rules Spark applies.

The tables are host arrays, cached per zone; ``expr/datetime.py`` moves
them to the column's device and resolves every row with one
``torch.searchsorted``.  The POSIX footer rule is materialized to 2200,
as in the reference.
"""
from __future__ import annotations

import functools
import os
import struct
from typing import Optional, Tuple

import numpy as np

_TZPATHS = ("/usr/share/zoneinfo", "/usr/lib/zoneinfo", "/etc/zoneinfo")

_MIN_I64 = -(2**63)


class UnknownTimeZone(ValueError):
    pass


def _read_tzif(name: str) -> Tuple[np.ndarray, np.ndarray]:
    """-> (transition utc seconds int64[n], offsets seconds int64[n+1]);
    offsets[0] applies before the first transition."""
    if "/" in name and ".." in name:
        raise UnknownTimeZone(name)
    path = None
    for base in _TZPATHS:
        p = os.path.join(base, name)
        if os.path.isfile(p):
            path = p
            break
    if path is None:
        raise UnknownTimeZone(name)
    with open(path, "rb") as f:
        data = f.read()

    def parse_block(buf, pos, time_size, fmt):
        (isutcnt, isstdcnt, leapcnt, timecnt, typecnt,
         charcnt) = struct.unpack_from(">6I", buf, pos + 20)
        pos += 44
        times = np.frombuffer(buf, dtype=fmt, count=timecnt,
                              offset=pos).astype(np.int64)
        pos += timecnt * time_size
        idxs = np.frombuffer(buf, dtype=np.uint8, count=timecnt, offset=pos)
        pos += timecnt
        ttinfo = []
        for k in range(typecnt):
            utoff, dst, ab = struct.unpack_from(">iBB", buf, pos + k * 6)
            ttinfo.append(utoff)
        pos += typecnt * 6 + charcnt + leapcnt * (time_size + 4)
        pos += isstdcnt + isutcnt
        return times, idxs, np.asarray(ttinfo, np.int64), pos

    if data[:4] != b"TZif":
        raise UnknownTimeZone(f"{name}: not a TZif file")
    version = data[4:5]
    times, idxs, ttinfo, pos = parse_block(data, 0, 4, ">i4")
    footer = b""
    if version in (b"2", b"3", b"4"):
        # the 64-bit block supersedes the 32-bit one
        times, idxs, ttinfo, end = parse_block(data, pos, 8, ">i8")
        footer = data[end:].strip(b"\n")
    if len(ttinfo) == 0:
        return (np.zeros(0, np.int64), np.zeros(1, np.int64))
    # offset BEFORE first transition: first ttinfo entry (RFC: first
    # standard-time entry; entry 0 is the common convention)
    first = ttinfo[0]
    offsets = np.concatenate([[first], ttinfo[idxs]]).astype(np.int64)
    times = times.astype(np.int64)
    # TZif tables usually stop ~2037; the POSIX footer rule governs the
    # open future — materialize it out to 2200 (java.time does the
    # equivalent with ZoneRules.getTransitionRules)
    ext = _extend_with_posix_rule(footer.decode("ascii", "ignore"),
                                  int(times[-1]) if len(times) else 0,
                                  int(offsets[-1]))
    if ext is not None:
        ft, fo = ext
        times = np.concatenate([times, ft])
        offsets = np.concatenate([offsets, fo])
    return times, offsets


def _parse_posix_offset(s: str, i: int):
    """[+|-]hh[:mm[:ss]] -> (seconds west-negative per POSIX -> we return
    the UTC offset in seconds, POSIX sign INVERTED), next index."""
    sign = 1
    if i < len(s) and s[i] in "+-":
        sign = -1 if s[i] == "-" else 1
        i += 1
    parts = [0, 0, 0]
    for k in range(3):
        j = i
        while j < len(s) and s[j].isdigit():
            j += 1
        if j == i:
            break
        parts[k] = int(s[i:j])
        i = j
        if i < len(s) and s[i] == ":":
            i += 1
        else:
            break
    secs = parts[0] * 3600 + parts[1] * 60 + parts[2]
    return -sign * secs, i  # POSIX: positive = west of UTC


def _days_in_month(y, m):
    import calendar

    return calendar.monthrange(y, m)[1]


def _rule_instant(year: int, rule: str, at: int, utoff: int) -> int:
    """POSIX Mm.w.d rule -> UTC seconds for that year's transition."""
    import datetime as _dt

    if rule.startswith("M"):
        m, w, d = (int(x) for x in rule[1:].split("."))
        # d-th day-of-week (0=Sunday) of week w (w=5: last)
        first = _dt.date(year, m, 1)
        dow_first = (first.weekday() + 1) % 7  # python Mon=0 -> Sun=0
        day = 1 + (d - dow_first) % 7 + (w - 1) * 7
        while day > _days_in_month(year, m):
            day -= 7
        local = _dt.datetime(year, m, day) + _dt.timedelta(seconds=at)
    elif rule.startswith("J"):
        n = int(rule[1:])  # 1..365, Feb 29 never counted
        local = (_dt.datetime(year, 1, 1)
                 + _dt.timedelta(days=n - 1, seconds=at))
        if n >= 60 and _days_in_month(year, 2) == 29:
            local += _dt.timedelta(days=1)
    else:
        n = int(rule)  # 0..365 incl leap day
        local = (_dt.datetime(year, 1, 1)
                 + _dt.timedelta(days=n, seconds=at))
    epoch = _dt.datetime(1970, 1, 1)
    return int((local - epoch).total_seconds()) - utoff


def _extend_with_posix_rule(footer: str, last_trans: int, last_off: int):
    """Materialize the footer rule's transitions for years after the table.

    Returns (times, offsets_after_each) or None for fixed-offset zones."""
    if not footer or "," not in footer:
        return None  # no DST rule: last offset holds forever
    try:
        head, start_rule, end_rule = footer.split(",")
        i = 0
        if head[i] == "<":
            i = head.index(">", i) + 1
        else:
            while i < len(head) and not (head[i].isdigit()
                                         or head[i] in "+-"):
                i += 1
        std_off, i = _parse_posix_offset(head, i)
        if i < len(head):
            j = i
            if head[j] == "<":
                j = head.index(">", j) + 1
            else:
                while j < len(head) and not (head[j].isdigit()
                                             or head[j] in "+-,"):
                    j += 1
            if j < len(head) and (head[j].isdigit() or head[j] in "+-"):
                dst_off, _ = _parse_posix_offset(head, j)
            else:
                dst_off = std_off + 3600
        else:
            dst_off = std_off + 3600

        def split_at(r, default=7200):
            if "/" in r:
                r, t = r.split("/")
                secs, _ = _parse_posix_offset(t, 0)
                return r, -secs  # parse returns inverted sign
            return r, default

        start_rule, start_at = split_at(start_rule)
        end_rule, end_at = split_at(end_rule)
        import datetime as _dt

        y0 = max((_dt.datetime(1970, 1, 1) + _dt.timedelta(
            seconds=max(last_trans, 0))).year, 1970)
        times, offs = [], []
        for year in range(y0, 2201):
            s = _rule_instant(year, start_rule, start_at, std_off)
            e = _rule_instant(year, end_rule, end_at, dst_off)
            for t, o in sorted([(s, dst_off), (e, std_off)]):
                if t > last_trans:
                    times.append(t)
                    offs.append(o)
        return (np.asarray(times, np.int64), np.asarray(offs, np.int64))
    except (ValueError, IndexError):
        return None


@functools.lru_cache(maxsize=256)
def zone_tables(name: str):
    """-> dict of numpy tables for one zone (host side, cached)."""
    trans, offsets = _read_tzif(name)
    # utc lookup: instants with sentinel -inf
    utc_instants = np.concatenate([[_MIN_I64], trans])
    # wall lookup: boundary = transition + max(off_before, off_after)
    if len(trans):
        wall = trans + np.maximum(offsets[:-1], offsets[1:])
    else:
        wall = trans
    wall_starts = np.concatenate([[_MIN_I64], wall])
    return {
        "utc_instants": utc_instants,          # (n+1,) seconds
        "wall_starts": wall_starts,            # (n+1,) seconds
        "offsets": offsets,                    # (n+1,) seconds
    }


def is_known_zone(name: Optional[str]) -> bool:
    if not isinstance(name, str) or not name:
        return False
    try:
        zone_tables(name)
        return True
    except (UnknownTimeZone, OSError, ValueError, struct.error):
        return False


def offsets_for_instants_np(name: str, micros: np.ndarray) -> np.ndarray:
    """Offset (seconds) in effect at each UTC instant (numpy, oracle-free
    helper for IO paths)."""
    t = zone_tables(name)
    secs = np.floor_divide(micros, 1_000_000)
    idx = np.searchsorted(t["utc_instants"], secs, side="right") - 1
    return t["offsets"][np.clip(idx, 0, len(t["offsets"]) - 1)]
