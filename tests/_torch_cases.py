"""Grouped cases of the port's serving tests: each test runs every case it
holds and fails naming each case that failed, so that no case hides a later
one. Why the cases are grouped: ROADMAP.md, queue 3, on the Tier-1
command's scheduling."""

import traceback

import pytest


def run_cases(cases) -> None:
    """Run every ``(name, thunk)`` of ``cases`` in order; then, if any
    failed, fail once with each failed case's name and traceback."""
    failed = []
    for name, thunk in cases:
        try:
            thunk()
        except (Exception, pytest.fail.Exception) as err:
            failed.append(f"--- case {name} failed:\n"
                          + "".join(traceback.format_exception(err)))
    if failed:
        pytest.fail(f"{len(failed)} of {len(cases)} cases failed\n"
                    + "\n".join(failed), pytrace=False)


def subdir(tmp_path, name: str):
    """A fresh directory of its own under the test's ``tmp_path``."""
    path = tmp_path / name
    path.mkdir()
    return path
