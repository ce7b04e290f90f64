"""Shared utilities (counterpart: ``deppy_tpu/utils/__init__.py``).

So far only :mod:`.lease`, the service's HA election.  The reference's
``check_solution`` (``utils/verify.py``) and ``force_cpu_env``
(``utils/platform_env.py``) come with ROADMAP A7.2.
"""
