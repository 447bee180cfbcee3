"""Model calendar: 365-day year with the reference's leap-day quirk
(source/date.f90), and the monthly interpolation weights
(interpolation.f90) as 12-vectors."""
from __future__ import annotations

import dataclasses

import numpy as np

NDAYCAL = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]
NCAL = 365
_CUM = np.concatenate([[0], np.cumsum(NDAYCAL)[:-1]])


@dataclasses.dataclass(frozen=True, order=True)
class Datetime:
    year: int
    month: int
    day: int
    hour: int = 0
    minute: int = 0


def _roll_day(day: int, month: int, year: int):
    """Month/year rollover, with February running to 29 days in years
    divisible by 4 (the reference's quirk, date.f90:129-139)."""
    if year % 4 == 0 and month == 2:
        if day > 29:
            day, month = 1, month + 1
    elif day > NDAYCAL[month - 1]:
        day, month = 1, month + 1
    if month > 12:
        month, year = 1, year + 1
    return day, month, year


def newdate(d: Datetime, nsteps: int) -> Datetime:
    """Advance by one model step (date.f90:109-157)."""
    minute = d.minute + int(24 * 60 / nsteps)
    hour, day = d.hour, d.day
    if minute >= 60:
        hour += 1
        minute = minute % 60
    if hour >= 24:
        hour = hour % 24
        day += 1
    day, month, year = _roll_day(day, d.month, d.year)
    return Datetime(year, month, day, hour, minute)


def next_day(d: Datetime) -> Datetime:
    """The date one calendar day later."""
    day, month, year = _roll_day(d.day + 1, d.month, d.year)
    return Datetime(year, month, day, d.hour, d.minute)


def season_vars(d: Datetime, iseasc: int = 1, start_month: int = 1):
    """(imont1, tmonth, tyear) (date.f90:97-105)."""
    if iseasc >= 1:
        imont1 = d.month
        tmonth = (d.day - 0.5) / NDAYCAL[d.month - 1]
        tyear = (_CUM[d.month - 1] + d.day - 0.5) / NCAL
    else:
        imont1 = start_month
        tmonth = 0.5
        tyear = (_CUM[imont1 - 1] + 0.5 * _CUM[imont1 - 1]) / NCAL
    return imont1, tmonth, tyear


def forint_weights(imon: int, tmonth: float, n: int = 12) -> np.ndarray:
    """Linear month-interpolation weights (interpolation.f90:16-35)."""
    w = np.zeros(n)
    if tmonth <= 0.5:
        imon2 = imon - 1 if imon > 1 else n
        wmon = 0.5 - tmonth
    else:
        imon2 = imon + 1 if imon < n else 1
        wmon = tmonth - 0.5
    w[imon - 1] += 1.0 - wmon
    w[imon2 - 1] += wmon
    return w


def forin5_weights(imon: int, tmonth: float) -> np.ndarray:
    """Mean-conserving 5-point monthly interpolation weights
    (interpolation.f90:38-69)."""
    c0 = 1.0 / 12.0
    t0 = c0 * tmonth
    t1 = c0 * (1.0 - tmonth)
    t2 = 0.25 * tmonth * (1.0 - tmonth)
    coeffs = {
        -2: -t1 + t2,
        -1: -c0 + 8 * t1 - 6 * t2,
        0: 7 * c0 + 10 * t2,
        1: -c0 + 8 * t0 - 6 * t2,
        2: -t0 + t2,
    }
    w = np.zeros(12)
    for off, c in coeffs.items():
        w[(imon - 1 + off) % 12] += c
    return w
