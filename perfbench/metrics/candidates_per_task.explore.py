"""Candidates a task enumerated in the window: the select's work, counted
from every answer's candidate count."""


def read(tracer, window):
    tasks = window.counts.get("tasks")
    if not tasks or "candidates" not in window.counts:
        return None
    return window.counts["candidates"] / tasks
