"""The port's chat-template renderer against jinja2.

Every template here renders through jinja2 (the JAX package's
``ChatTemplate`` environment: StrictUndefined, trim_blocks,
lstrip_blocks) and through ``dynamo_tpu_torch.llm.template``, over
hypothesis-made message lists: the outputs must be equal, and where
jinja2 raises UndefinedError the port must raise its UndefinedError.
The templates are the default chat template, the tools template of
tests/test_llm_layer.py, and one template per construct of the subset.
Constructs outside the subset raise when the port's preprocessor is
built.
"""

from __future__ import annotations

import jinja2
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.llm import preprocessor as jpre
from dynamo_tpu.llm.protocols import ChatMessage as JMessage
from dynamo_tpu_torch.llm import preprocessor as tpre
from dynamo_tpu_torch.llm import template as T
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.protocols import ChatMessage as TMessage

TOOLS_TEMPLATE = (
    "{% if tools %}TOOLS:{% for t in tools %}{{ t.function.name }};{% endfor %}\n{% endif %}"
    "{% for m in messages %}{{ m.role }}: {{ m.content }}\n{% endfor %}"
)

# One template per construct of the subset (and the whitespace rules).
CONSTRUCTS = {
    "text_and_comment": "head {# a comment #}tail\n{#- stripped -#}\n  after",
    "expr": "{{ messages[0].content }}|{{ messages[0]['role'] }}|{{ bos_token }}",
    "loop_vars": ("{% for m in messages %}{{ loop.index0 }}/{{ loop.index }}/{{ loop.length }}"
                  "{% if loop.first %}F{% endif %}{% if loop.last %}L{% endif %}"
                  "{{ loop.revindex }}{{ loop.revindex0 }};{% endfor %}"),
    "if_elif_else": ("{% for m in messages %}{% if m.role == 'system' %}S{% elif m.role == 'user' %}"
                     "U{% elif m.role != 'tool' %}A{% else %}T{% endif %}{% endfor %}"),
    "set": ("{% set sep = '::' %}{% set n = 0 %}{% for m in messages %}{% set n = n + 1 %}"
            "{{ n }}{{ sep }}{% endfor %}{{ n }}"),
    "whitespace": ("  {% for m in messages %}\n    {%- if m.content %}\n  {{ m.role }}\n"
                   "    {% endif -%}\n  {%+ if true %} keep {% endif %}\n  {% endfor %}\n"),
    "literals": "{{ 'a' ~ \"b\" ~ 1 ~ true ~ none }}{{ True }}{{ None is none }}{{ 12 }}",
    "operators": ("{{ messages|length > 1 and 'many' or 'one' }}{{ 'x' in 'xyz' }}"
                  "{{ 'q' not in 'xyz' }}{{ not false }}{{ 1 + 2 }}{{ 'a' + 'b' }}{{ 2 < 3 }}"
                  "{{ 3 <= 3 }}{{ 4 >= 5 }}{{ (1 + 2) ~ '!' }}"),
    "tests": ("{{ messages is defined }}{{ nothing is defined }}{{ nothing is not defined }}"
              "{{ add_generation_prompt is none }}{{ tools is not none }}"),
    "filters": ("{% for m in messages %}{{ m.content|trim|upper }}|{{ m.role|lower }}|"
                "{{ m.content|length }}|{{ m|tojson }}{% endfor %}"),
    "raise": ("{% for m in messages %}{% if m.role == 'tool' %}{{ raise_exception('no tools') }}"
              "{% endif %}{% endfor %}ok"),
    "strict_undefined": "{% for m in messages %}{{ m.name }}{% endfor %}",
    "attr_then_item": "{% for m in messages %}{{ m.items is defined }}{{ m['role'] }}{% endfor %}",
}

OUTSIDE = [
    "{% macro f() %}x{% endmacro %}",
    "{{ messages | join(',') }}",
    "{{ messages[1:] }}",
    "{{ 'a' if true else 'b' }}",
    "{% for a, b in messages %}{% endfor %}",
    "{{ messages[0].content.strip() }}",
    "{% raw %}{{ x }}{% endraw %}",
    "{{ 3 - 1 }}",
    "{{ loop.cycle('a', 'b') }}",
    "{% set ns = namespace(found=false) %}",
    "{{ messages | selectattr('role') }}",
    "{{ x is string }}",
    "{% for m in messages %}{% else %}{% endfor %}",
    "{% for m in messages if m.role %}{% endfor %}",
    "{{ [1, 2] }}",
    "{{ 1.5 }}",
    "{% include 'other' %}",
    "{% set a.b = 1 %}",
    "{{ m|trim('x') }}",
]

roles = st.sampled_from(["system", "user", "assistant", "tool"])
content = st.text(alphabet=st.characters(codec="utf-8", exclude_categories=("Cs",)),
                  max_size=24) | st.sampled_from(["  padded  ", "{{ not a tag }}", "<b>&'\"", "\n"])
messages = st.lists(st.fixed_dictionaries({"role": roles, "content": content}),
                    min_size=1, max_size=5)


def jinja_env():
    env = jinja2.Environment(loader=jinja2.BaseLoader(), autoescape=False,
                             undefined=jinja2.StrictUndefined, trim_blocks=True,
                             lstrip_blocks=True)
    env.globals["raise_exception"] = _raise
    return env


def port_env():
    env = T.Environment(loader=T.BaseLoader(), autoescape=False, undefined=T.StrictUndefined,
                        trim_blocks=True, lstrip_blocks=True)
    env.globals["raise_exception"] = _raise
    return env


class Raised(Exception):
    pass


def _raise(msg):
    raise Raised(msg)


def outcome(env, src, undefined_error, **kw):
    try:
        return env.from_string(src).render(**kw)
    except undefined_error:
        return "<UndefinedError>"
    except Raised as e:
        return f"<raised {e}>"


def render_both(src, **kw):
    return (outcome(jinja_env(), src, jinja2.UndefinedError, **kw),
            outcome(port_env(), src, T.UndefinedError, **kw))


@settings(max_examples=40, deadline=None)
@given(messages, st.booleans())
def test_default_template_matches_jinja2(msgs, gen_prompt):
    """Through both preprocessors' ChatTemplate, on ChatMessage lists."""
    j = jpre.ChatTemplate().render([JMessage.parse(m) for m in msgs], gen_prompt)
    t = tpre.ChatTemplate().render([TMessage.parse(m) for m in msgs], gen_prompt)
    assert t == j


@settings(max_examples=40, deadline=None)
@given(messages, st.lists(st.text(alphabet="abcdefgh_", min_size=1, max_size=8), max_size=3))
def test_tools_template_matches_jinja2(msgs, names):
    tools = [{"type": "function", "function": {"name": n, "parameters": {}}} for n in names]
    j = jpre.ChatTemplate(TOOLS_TEMPLATE).render([JMessage.parse(m) for m in msgs], tools=tools)
    t = tpre.ChatTemplate(TOOLS_TEMPLATE).render([TMessage.parse(m) for m in msgs], tools=tools)
    assert t == j


@pytest.mark.parametrize("name", sorted(CONSTRUCTS))
@settings(max_examples=25, deadline=None)
@given(msgs=messages, gen_prompt=st.booleans(), with_tools=st.booleans())
def test_construct_matches_jinja2(name, msgs, gen_prompt, with_tools):
    kw = dict(messages=msgs, add_generation_prompt=gen_prompt, bos_token="<s>", eos_token="",
              tools=[{"function": {"name": "f"}}] if with_tools else None)
    j, t = render_both(CONSTRUCTS[name], **kw)
    assert t == j


def test_constructs_render_something():
    """The per-construct templates are not vacuous: each renders text (or
    raises as intended) on a fixed message list."""
    msgs = [{"role": "system", "content": " sys "}, {"role": "user", "content": "hi"},
            {"role": "tool", "content": "t"}]
    for name, src in CONSTRUCTS.items():
        j, t = render_both(src, messages=msgs, add_generation_prompt=True, bos_token="<s>",
                           eos_token="", tools=None)
        assert t == j and j, name
    assert render_both(CONSTRUCTS["raise"], messages=msgs)[1] == "<raised no tools>"
    assert render_both(CONSTRUCTS["strict_undefined"], messages=msgs)[1] == "<UndefinedError>"


@pytest.mark.parametrize("src", OUTSIDE)
def test_outside_subset_raises_when_the_preprocessor_is_built(src):
    card = ModelDeploymentCard(name="m", chat_template=src)
    with pytest.raises(T.TemplateSyntaxError):
        tpre.OpenAIPreprocessor(card)


def test_undefined_surfaces_as_the_preprocessors_error():
    """A template reading a missing field fails the request the way the
    JAX preprocessor does (OpenAIError 500), never renders a prompt."""
    from dynamo_tpu.llm.protocols import OpenAIError as JErr
    from dynamo_tpu_torch.llm.protocols import OpenAIError as TErr

    src = "{% for m in messages %}{{ m.name }}{% endfor %}"
    msgs = [{"role": "user", "content": "x"}]
    with pytest.raises(JErr) as je:
        jpre.ChatTemplate(src).render([JMessage.parse(m) for m in msgs])
    with pytest.raises(TErr) as te:
        tpre.ChatTemplate(src).render([TMessage.parse(m) for m in msgs])
    assert je.value.status == te.value.status == 500


# -- templates made by hypothesis from the subset's grammar ----------------------

_EXPRS = ["m.role", "m['content']", "m.content|trim", "loop.index0", "loop.last", "'x' ~ m.role",
          "m.role == 'user'", "m.content|length > 2", "not loop.first", "bos_token",
          "add_generation_prompt", "m.role in 'user assistant'", "m.name is defined",
          "tools is none", "m.content|upper", "n"]
_CONDS = ["loop.first", "m.role == 'user'", "m.role != 'tool' and not loop.last",
          "m.content", "add_generation_prompt or loop.last", "m.name is not defined", "n > 1"]
_WS = st.sampled_from(["", " ", "  ", "\n", " \n", "\n  ", "\t", "\n\n", "x", "ab\n  "])
_L = st.sampled_from(["", "-", "+"])   # after {% / {#: strip before, or keep (no lstrip)
_R = st.sampled_from(["", "-", "+"])   # before %}: strip after, or keep (no trim)
_V = st.sampled_from(["", "-"])        # {{- / -}}


def _stmt(l: str, body: str, r: str) -> str:
    return "{%" + l + " " + body + " " + r + "%}"


@st.composite
def _expr_tag(draw):
    return "{{" + draw(_V) + " " + draw(st.sampled_from(_EXPRS)) + " " + draw(_V) + "}}"


@st.composite
def _block(draw, depth=0):
    parts = []
    for _ in range(draw(st.integers(1, 4))):
        kind = draw(st.sampled_from(["text", "expr", "comment"] + (["if", "set"] if depth < 2
                                                                   else [])))
        ws = draw(_WS)
        if kind == "text":
            parts.append(ws)
        elif kind == "expr":
            parts.append(ws + draw(_expr_tag()))
        elif kind == "comment":
            parts.append(ws + "{#" + draw(_L) + " note " + draw(_R) + "#}")
        elif kind == "set":
            parts.append(ws + _stmt(draw(_L), "set n = n + 1", draw(_R)))
        else:
            body = draw(_block(depth + 1))
            other = draw(_block(depth + 1))
            parts.append(ws + _stmt(draw(_L), "if " + draw(st.sampled_from(_CONDS)), draw(_R))
                         + body + draw(_WS) + _stmt(draw(_L), "else", draw(_R)) + other
                         + draw(_WS) + _stmt(draw(_L), "endif", draw(_R)))
    return "".join(parts)


@st.composite
def templates(draw):
    head = draw(_WS)
    return (head + "{% set n = 0 %}" + draw(_WS) + _stmt(draw(_L), "for m in messages", draw(_R))
            + draw(_block()) + draw(_WS) + _stmt(draw(_L), "endfor", draw(_R)) + draw(_WS)
            + draw(st.sampled_from(["", "\n", "{{ n }}\n", "end"])))


@settings(max_examples=300, deadline=None)
@given(src=templates(), msgs=messages, trim=st.booleans(), lstrip=st.booleans())
def test_generated_templates_match_jinja2(src, msgs, trim, lstrip):
    """Random compositions of text, tags, comments and whitespace control
    under every trim_blocks / lstrip_blocks setting: the same output (or
    both raise UndefinedError)."""
    kw = dict(messages=msgs, add_generation_prompt=True, bos_token="<s>", tools=None)
    je = jinja2.Environment(loader=jinja2.BaseLoader(), autoescape=False,
                            undefined=jinja2.StrictUndefined, trim_blocks=trim,
                            lstrip_blocks=lstrip)
    te = T.Environment(loader=T.BaseLoader(), autoescape=False, undefined=T.StrictUndefined,
                       trim_blocks=trim, lstrip_blocks=lstrip)
    assert outcome(te, src, T.UndefinedError, **kw) == outcome(je, src, jinja2.UndefinedError,
                                                               **kw)
