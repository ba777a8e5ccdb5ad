"""Downstream evaluation of a frozen representation: the behaviour-cloning probe (`bc`) and
the reach-world probe fixture (`fixtures`), the port of ``r3m_tpu/evalsuite``."""
