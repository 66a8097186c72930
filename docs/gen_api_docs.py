"""Generate static HTML API documentation for pysgmcmc_tpu.

The reference ships a Sphinx/readthedocs tree with one API page per module
(``/root/reference/docs/source/api.rst:8-15``, ``docs/source/conf.py``).
Sphinx is not available in this environment, so this generator walks the
package with ``inspect`` and emits the same artifact: an index page plus
one HTML page per public module, with class/function signatures and full
docstrings (including the executable examples that the doctest suite runs).

Usage: ``python docs/gen_api_docs.py [output_dir]`` (default
``docs/_build/html``); wired to ``make docs``.
"""

import html
import importlib
import inspect
import os
import pkgutil
import sys

import pysgmcmc_tpu

STYLE = """
body { font-family: -apple-system, 'Segoe UI', Roboto, sans-serif;
       max-width: 60rem; margin: 2rem auto; padding: 0 1rem; color: #1a1a2e; }
h1, h2, h3 { color: #16324f; }
code, pre { font-family: 'SF Mono', Consolas, monospace; font-size: 0.9em; }
pre { background: #f6f8fa; border: 1px solid #d8dee4; border-radius: 6px;
      padding: 0.8rem; overflow-x: auto; white-space: pre-wrap; }
.sig { background: #eef3f8; border-left: 3px solid #2d6a9f; padding: 0.4rem
       0.8rem; margin-top: 1.5rem; font-family: monospace; }
.kind { color: #7a7a8c; font-size: 0.8em; text-transform: uppercase;
        letter-spacing: 0.05em; }
a { color: #2d6a9f; text-decoration: none; }
a:hover { text-decoration: underline; }
ul.index li { margin: 0.3rem 0; }
.modsummary { color: #444; }
"""


def iter_modules():
    """All importable pysgmcmc_tpu modules, sorted, private ones excluded
    except the documented ``samplers._adaptive``."""
    names = ["pysgmcmc_tpu"]
    for info in pkgutil.walk_packages(
        pysgmcmc_tpu.__path__, prefix="pysgmcmc_tpu."
    ):
        base = info.name.rsplit(".", 1)[-1]
        if base.startswith("_") and base != "_adaptive":
            continue
        names.append(info.name)
    return sorted(names)


def first_line(doc):
    doc = inspect.getdoc(doc if isinstance(doc, str) else doc) or ""
    for line in (doc if isinstance(doc, str) else "").splitlines():
        if line.strip():
            return line.strip()
    return ""


def esc(text):
    return html.escape(text or "")


def signature_of(obj):
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"


def render_member(name, obj, prefix=""):
    parts = []
    if inspect.isclass(obj):
        parts.append(
            '<div class="sig" id="{0}"><span class="kind">class</span> '
            "<b>{0}</b>{1}</div>".format(esc(name), esc(signature_of(obj)))
        )
        doc = inspect.getdoc(obj)
        if doc:
            parts.append("<pre>{}</pre>".format(esc(doc)))
        for mname, member in inspect.getmembers(obj):
            if mname.startswith("_") and mname not in (
                "__next__", "__iter__", "__len__", "__getitem__"
            ):
                continue
            if not (
                inspect.isfunction(member) or inspect.ismethod(member)
            ):
                continue
            if member.__qualname__.split(".")[0] != obj.__name__:
                continue  # inherited
            parts.append(
                '<div class="sig" style="margin-left:1.5rem">'
                '<span class="kind">method</span> <b>{}</b>{}</div>'.format(
                    esc(mname), esc(signature_of(member))
                )
            )
            mdoc = inspect.getdoc(member)
            if mdoc:
                parts.append(
                    '<pre style="margin-left:1.5rem">{}</pre>'.format(esc(mdoc))
                )
    elif inspect.isfunction(obj):
        parts.append(
            '<div class="sig" id="{0}"><span class="kind">function</span> '
            "<b>{0}</b>{1}</div>".format(esc(name), esc(signature_of(obj)))
        )
        doc = inspect.getdoc(obj)
        if doc:
            parts.append("<pre>{}</pre>".format(esc(doc)))
    return "\n".join(parts)


def render_module(modname):
    module = importlib.import_module(modname)
    parts = [
        "<!doctype html><meta charset='utf-8'>",
        "<title>{} — pysgmcmc_tpu API</title>".format(esc(modname)),
        "<style>{}</style>".format(STYLE),
        "<p><a href='index.html'>&larr; API index</a></p>",
        "<h1><code>{}</code></h1>".format(esc(modname)),
    ]
    moddoc = inspect.getdoc(module)
    if moddoc:
        parts.append("<pre>{}</pre>".format(esc(moddoc)))

    members = []
    for name, obj in inspect.getmembers(module):
        if name.startswith("_"):
            continue
        if getattr(obj, "__module__", None) != modname:
            continue  # re-exports documented at their home module
        if inspect.isclass(obj) or inspect.isfunction(obj):
            members.append((name, obj))
    for name, obj in members:
        parts.append(render_member(name, obj))
    return "\n".join(parts), moddoc or ""


def main(out_dir=None):
    out_dir = out_dir or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "_build", "html"
    )
    os.makedirs(out_dir, exist_ok=True)

    entries = []
    for modname in iter_modules():
        page, moddoc = render_module(modname)
        fname = modname.replace(".", "_") + ".html"
        with open(os.path.join(out_dir, fname), "w") as fh:
            fh.write(page)
        entries.append((modname, fname, first_line(moddoc)))

    index = [
        "<!doctype html><meta charset='utf-8'>",
        "<title>pysgmcmc_tpu API documentation</title>",
        "<style>{}</style>".format(STYLE),
        "<h1>pysgmcmc_tpu API documentation</h1>",
        "<p class='modsummary'>Stochastic-gradient MCMC in JAX: "
        "samplers, parallel chains over device meshes, diagnostics, and "
        "Bayesian model families.  Generated from the package docstrings; "
        "all examples are executed by the doctest suite.</p>",
        "<p>New here?  Start with the executed narrative walkthrough: "
        "<a href='getting_started.html'>Getting started</a>.</p>",
        "<ul class='index'>",
    ]
    for modname, fname, summary in entries:
        index.append(
            "<li><a href='{}'><code>{}</code></a> — {}</li>".format(
                fname, esc(modname), esc(summary)
            )
        )
    index.append("</ul>")
    with open(os.path.join(out_dir, "index.html"), "w") as fh:
        fh.write("\n".join(index))
    print(
        "wrote {} module pages + index to {}".format(len(entries), out_dir)
    )


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
