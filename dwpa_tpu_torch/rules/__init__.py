"""Hashcat-compatible rule engine: the host interpreter (``engine``) and
the torch interpreter of the same language (``device``)."""

import os

from .engine import Rule, RuleError, apply_rules, parse_rule, parse_rules  # noqa: F401

#: the bundled WPA-tuned ruleset (the bestWPA.rule asset equivalent)
WPA_RULE_PATH = os.path.join(os.path.dirname(__file__), "wpa.rule")


def wpa_rules():
    """The bundled WPA ruleset, parsed (see wpa.rule for provenance)."""
    with open(WPA_RULE_PATH) as f:
        return parse_rules(f.read().splitlines())


def wpa_rules_text() -> str:
    """Raw text of the bundled ruleset (for dicts-table attachment)."""
    with open(WPA_RULE_PATH) as f:
        return f.read()
