"""Env-steps completed per second over the whole window: every unit's
envs x steps over the time from the first unit's start to the last's end."""

from window import rate


def read(record):
    return rate(record["units"])
