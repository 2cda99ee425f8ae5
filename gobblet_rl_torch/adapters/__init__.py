"""Framework adapters (Tianshou, RLlib), each importable only where its
framework is installed.

Port of ``gobblet_rl_tpu/adapters/``.  Neither framework is a dependency
of the port: each adapter module raises an ``ImportError`` that names the
framework-free equivalent (``policies/``, ``interactive/session.py``,
``train/ppo.py``) when its framework is missing.  Host only.
"""
