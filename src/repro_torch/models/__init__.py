"""The decoder-only LM of the seed-era model stack (dense and SSM
families): ``api`` is the entry point, ``lm`` / ``blocks`` / ``attention``
/ ``ssm`` / ``layers`` mirror ``repro.models``."""
