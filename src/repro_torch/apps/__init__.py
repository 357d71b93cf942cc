"""Replicated applications: the matching engine (``apps/matching.py``, a
verbatim copy of ``repro.apps.matching``), whose orders
``workloads/matching.py`` makes."""
