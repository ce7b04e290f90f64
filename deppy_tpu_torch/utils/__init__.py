"""Shared utilities (counterpart: ``deppy_tpu/utils/__init__.py``).

:mod:`.lease`, the service's HA election, and :mod:`.verify`, the
independent solution checker.  The reference's ``force_cpu_env``
(``utils/platform_env.py``) comes with ROADMAP A7.2c.
"""
