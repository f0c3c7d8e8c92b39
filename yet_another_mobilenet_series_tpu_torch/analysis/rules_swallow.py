# Copy of yet_another_mobilenet_series_tpu/analysis/rules_swallow.py
# (the port's analyzer: pure-stdlib AST, no torch or jax import)
"""YAMT012 — silent broad-exception swallows in package code.

``except Exception: pass`` is how real failures become ghosts: the restore
path's legacy-retry bug (cli/train.py pre-robustness) treated EVERY restore
failure — including genuine checkpoint corruption — as a known benign shape
quirk, because a broad handler with no body cannot tell the difference and
tells no one. The rule: a handler that catches a BROAD exception class
(bare ``except:``, ``Exception``, ``BaseException``, or a tuple containing
one) must DO something — log, count, re-raise, return a fallback. A body
consisting only of ``pass``/``...`` is a silent swallow and is flagged.

Deliberately NOT flagged:

- **narrow handlers** (``except OSError: pass`` around ``os.unlink``): the
  author named the failure they are ignoring — that is a decision, not a
  blindfold;
- **``__del__`` finalizers**: raising in a finalizer only prints unraisable
  noise during interpreter shutdown; swallowing there is the sanctioned
  idiom (data/native_loader.py);
- handlers with ANY real statement — what the handler does is the author's
  policy; the rule only insists the swallow is visible in the code.

Scope: package code only (a directory holding ``__init__.py``), like
YAMT007/YAMT011 — standalone scripts and tests exempt. Intentional swallows
in package code carry a same-line suppression with a WHY comment
(docs/LINT.md house rule)::

    except Exception:  # yamt-lint: disable=YAMT012 — keep last good reading
        pass
"""

from __future__ import annotations

import ast
import os

from .core import Finding, Project, Rule, SourceFile, register

_BROAD = ("Exception", "BaseException")


def _is_broad(type_node: ast.expr | None) -> bool:
    if type_node is None:
        return True  # bare except
    if isinstance(type_node, ast.Tuple):
        return any(_is_broad(el) for el in type_node.elts)
    return isinstance(type_node, ast.Name) and type_node.id in _BROAD


def _is_silent(handler: ast.ExceptHandler) -> bool:
    """True when the handler body does nothing observable: only pass / ...
    statements (a docstring-style constant counts as nothing too)."""
    for st in handler.body:
        if isinstance(st, ast.Pass):
            continue
        if isinstance(st, ast.Expr) and isinstance(st.value, ast.Constant):
            continue  # bare Ellipsis or stray string literal
        return False
    return True


def _del_handler_ids(tree: ast.Module) -> set[int]:
    """Handlers living inside ``__del__`` methods — exempt (see docstring)."""
    out: set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == "__del__":
            for sub in ast.walk(node):
                if isinstance(sub, ast.ExceptHandler):
                    out.add(id(sub))
    return out


@register
class SilentExceptionSwallow(Rule):
    id = "YAMT012"
    name = "silent-exception-swallow"
    description = (
        "a broad except (bare / Exception / BaseException) whose body is only "
        "pass: the failure disappears without a trace — log it, count it, "
        "re-raise it, or narrow the type to the failure you mean to ignore "
        "(__del__ finalizers exempt)"
    )

    def check_file(self, src: SourceFile, project: Project) -> list[Finding]:
        # package code only: a dir with __init__.py (scripts/tests exempt)
        if not os.path.exists(os.path.join(os.path.dirname(src.path), "__init__.py")):
            return []
        exempt = None
        findings: list[Finding] = []
        for node in src.nodes:
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not (_is_broad(node.type) and _is_silent(node)):
                continue
            if exempt is None:
                exempt = _del_handler_ids(src.tree)
            if id(node) in exempt:
                continue
            what = "bare except" if node.type is None else "broad except"
            findings.append(Finding(
                src.path, node.lineno, node.col_offset, self.id,
                f"{what} with a pass-only body silently swallows every failure: "
                "log/count/re-raise, or narrow the exception type to the one "
                "failure this means to ignore",
            ))
        return findings
