"""labwidget: a dependency-free Python<->JS widget framework for Jupyter.

The port's copy of the JAX package's ``ui/labwidget.py``, a clean-room
rebuild of the reference's widget system (utils/labwidget.py): ``Model``
objects holding ``Property`` values and ``Trigger`` events that
synchronize both ways with a browser view, with a compact JS runtime.  It
works headless too: every state change and event can be driven from
Python (that is how the app logic is tested), and in a live kernel the
HTML repr wires a comm channel.  The view-side runtime probes three
transports (the reference's WIDGET_ENV dispatch, utils/labwidget.py:
1010-1076): the Colab comm API (``google.colab.kernel.comms``), the
classic-notebook ``Jupyter`` global, and the JupyterLab/Notebook-7
application object (``jupyter lab --expose-app-in-browser``); all three
speak to the same kernel-side 'labwidget' comm target served by ipykernel.
IPython is imported only when a widget is displayed.

Key semantics mirrored from the reference:
- setting ``widget.prop = value`` notifies Python listeners and the view;
- ``on('propname', cb)`` / ``off`` register listeners for changes;
- Triggers fire events without holding state;
- widgets compose by embedding each other's ``_repr_html_``.
"""

from __future__ import annotations

import html as _html
import itertools
import json
from typing import Any, Callable, Dict, List, Optional

_id_counter = itertools.count(1)

# ---------------------------------------------------------------------------
# event re-entrancy control + handler output capture
# (reference utils/labwidget.py:480-544)
# ---------------------------------------------------------------------------

_entered_handler_stack: List["block_events"] = []


class block_events:
    """Context manager marking 'inside an event handler'.  External
    (user-registered) listeners are silenced while any external handler is
    already running — property writes made inside a handler update state
    and the view but do not cascade into further Python listeners
    (reference labwidget.py:484-506).  Internal listeners (the framework's
    own, e.g. view sync) are silenced only on exact recursion of the same
    (name, callback) pair."""

    def __init__(self, name: str = "block_events", cb: Callable = None,
                 internal: bool = False):
        self.internal = internal
        self.cb = cb
        self.name = name
        if not internal:
            self.silence = any(not s.internal
                               for s in _entered_handler_stack)
        else:
            self.silence = any(s.cb == cb and s.name == name
                               for s in _entered_handler_stack)

    def __enter__(self):
        _entered_handler_stack.append(self)
        return self

    def __exit__(self, exc_type, exc_value, exc_tb):
        _entered_handler_stack.pop()


class capture_output:
    """Capture stdout/stderr (and exceptions) raised by handler code and
    route them to ``widget.write`` so they render above the widget instead
    of vanishing into the kernel log (reference labwidget.py:509-544).
    Used by the comm receive path around view-triggered handlers."""

    def __init__(self, widget):
        from io import StringIO
        self.widget = widget
        self.buffer = StringIO()

    def __enter__(self):
        import sys
        self.saved = dict(stdout=sys.stdout, stderr=sys.stderr)
        sys.stdout = self.buffer
        sys.stderr = self.buffer
        return self

    def __exit__(self, exc_type, exc_value, exc_tb):
        import sys
        import traceback
        captured = self.buffer.getvalue()
        sys.stdout = self.saved["stdout"]
        sys.stderr = self.saved["stderr"]
        if captured and "write" in self.widget.property_names():
            self.widget.trigger(
                "write", f"<pre>{_html.escape(captured)}</pre>")
        if exc_type and "write" in self.widget.property_names():
            tbtxt = "".join(traceback.format_exception(
                exc_type, exc_value, exc_tb))
            self.widget.trigger(
                "write",
                f'<pre style="color:red;text-align:left">'
                f"{_html.escape(tbtxt)}</pre>")
        return False


class Property:
    """A synchronized value. Declared as a class or instance attribute of a
    Model; reads/writes go through the model."""

    def __init__(self, value=None):
        self.value = value

    def copy(self):
        return Property(self.value)


class Trigger(Property):
    """An event channel: no persistent value, just notifications."""

    def __init__(self):
        super().__init__(None)

    def copy(self):
        return Trigger()


class _Binding:
    __slots__ = ("prop", "listeners")

    def __init__(self, prop):
        self.prop = prop
        self.listeners: List[Callable] = []


class Model:
    """Holds named Properties/Triggers with change notification."""

    def __init__(self, **kwargs):
        object.__setattr__(self, "_bindings", {})
        # class-level Property declarations become per-instance bindings
        for klass in reversed(type(self).__mro__):
            for name, value in vars(klass).items():
                if isinstance(value, Property):
                    self._bindings[name] = _Binding(value.copy())
        for name, value in kwargs.items():
            self._declare_or_set(name, value)

    def _declare_or_set(self, name, value):
        if isinstance(value, Property):
            self._bindings[name] = _Binding(value)
        elif name in self._bindings:
            self.set(name, value)
        else:
            object.__setattr__(self, name, value)

    # -- attribute routing ---------------------------------------------------
    # class-level Property declarations would shadow instance lookups, so
    # bound names are routed through __getattribute__
    def __getattribute__(self, name):
        if not name.startswith("_"):
            bindings = object.__getattribute__(self, "__dict__").get(
                "_bindings")
            if bindings and name in bindings:
                return bindings[name].prop.value
        return object.__getattribute__(self, name)

    def __setattr__(self, name, value):
        if name in self._bindings and not isinstance(value, Property):
            self.set(name, value)
        else:
            self._declare_or_set(name, value)

    # -- API -------------------------------------------------------------------
    def prop(self, name) -> Property:
        return self._bindings[name].prop

    def set(self, name, value, _from_view=False):
        b = self._bindings[name]
        if not isinstance(b.prop, Trigger):
            b.prop.value = value
        for cb in list(b.listeners):
            # silence cascaded external listeners while inside a handler
            # (reference labwidget.py:405-412): handlers may update other
            # properties (state + view) without re-triggering Python logic
            with block_events(name, cb) as ctx:
                if not ctx.silence:
                    cb(value)
        if not _from_view:
            self._send_to_view(name, value)

    def trigger(self, name, value=None):
        self.set(name, value)

    def on(self, names, cb):
        for name in names.split():
            self._bindings[name].listeners.append(cb)
        return self

    def off(self, names, cb=None):
        for name in names.split():
            b = self._bindings[name]
            if cb is None:
                b.listeners.clear()
            elif cb in b.listeners:
                b.listeners.remove(cb)
        return self

    def property_names(self):
        return list(self._bindings)

    def _send_to_view(self, name, value):
        pass  # overridden by Widget when a comm is open


_COMM_JS = r"""
(function() {
  var model = {id: "%(id)s", props: %(props)s, comm: null, handlers: {},
               pending: []};
  function recv(d) {
    model.props[d.name] = d.value;
    (model.handlers[d.name] || []).forEach(function(h) { h(d.value); });
  }
  // Colab's comm opens asynchronously: events fired between render and
  // comm-open must not be dropped, so sends queue until attach() flushes.
  model.attach = function(comm) {
    model.comm = comm;
    model.pending.forEach(function(d) { comm.send(d); });
    model.pending = [];
  };
  function connect() {
    // Environment dispatch (the reference selects a transport by
    // WIDGET_ENV, utils/labwidget.py:1010-1076; here one runtime probes
    // at view time).  All three transports speak to the SAME kernel-side
    // 'labwidget' comm target — ipykernel serves Colab and JupyterLab
    // alike, so only the view-side wiring differs.
    // 1. Colab: promise-based comm API.
    if (typeof google !== 'undefined' && google.colab &&
        google.colab.kernel && google.colab.kernel.comms) {
      google.colab.kernel.comms.open('labwidget', {id: model.id}).then(
        function(comm) {
          model.attach({send: function(d) { comm.send(d); }});
          (function pump(it) {
            it.next().then(function(r) {
              if (r.done) { return; }
              recv(r.value.data);
              pump(it);
            }, function(err) {
              // iterator rejected (kernel restart / comm teardown):
              // stop pumping loudly instead of leaking an unhandled
              // rejection with a silently desynced view
              console.warn('labwidget colab pump stopped', err);
            });
          })(comm.messages[Symbol.asyncIterator]());
        },
        function(err) {
          // open rejected: attach a sink so sends drop (pre-queue
          // semantics) instead of queueing forever
          console.warn('labwidget comm open failed', err);
          model.attach({send: function(d) {}});
        });
      return;
    }
    // 2. Classic Jupyter notebook: global Jupyter kernel object.
    if (typeof Jupyter !== 'undefined' && Jupyter.notebook &&
        Jupyter.notebook.kernel) {
      var jc = Jupyter.notebook.kernel.comm_manager.new_comm(
          'labwidget', {id: model.id});
      jc.on_msg(function(msg) { recv(msg.content.data); });
      model.attach(jc);
      return;
    }
    // 3. JupyterLab / Notebook 7: no kernel global in output areas; use
    //    the application object when exposed (jupyter lab
    //    --expose-app-in-browser sets window.jupyterapp) to open a comm
    //    on the current session's kernel connection.
    var app = window.jupyterapp || window.jupyterlab;
    var ctx = app && app.shell && app.shell.currentWidget &&
        app.shell.currentWidget.sessionContext;
    var kernel = ctx && ctx.session && ctx.session.kernel;
    if (kernel && kernel.createComm) {
      var c = kernel.createComm('labwidget');
      c.open({id: model.id});
      c.onMsg = function(msg) { recv(msg.content.data); };
      model.attach({send: function(d) { c.send(d); }});
      return;
    }
  }
  model.set = function(name, value) {
    model.props[name] = value;
    var d = {name: name, value: value};
    if (model.comm) { model.comm.send(d); }
    else {
      // bound the queue: with no transport ever attaching (static HTML
      // export, nbviewer), keep only the most recent sends
      model.pending.push(d);
      if (model.pending.length > 256) { model.pending.shift(); }
    }
    (model.handlers[name] || []).forEach(function(h) { h(value); });
  };
  model.on = function(name, h) {
    (model.handlers[name] = model.handlers[name] || []).push(h);
  };
  connect();
  model.on("write", function(v) {
    var el = document.getElementById(model.id);
    if (el && el.parentNode) {
      var d = document.createElement("div");
      d.innerHTML = v;
      el.parentNode.insertBefore(d, el);
    }
  });
  window._labwidget_models = window._labwidget_models || {};
  window._labwidget_models[model.id] = model;
  %(setup)s
})();
"""


_WIDGET_REGISTRY: Dict[str, "Widget"] = {}
_COMM_TARGET_REGISTERED = [False]


def _register_comm_target():  # pragma: no cover - requires live kernel
    """Register the kernel-side 'labwidget' comm target once: the JS
    runtime opens a comm with {id: view_id}; incoming messages route to
    the widget's set(..., _from_view=True)."""
    if _COMM_TARGET_REGISTERED[0]:
        return
    try:
        ip = get_ipython()  # noqa: F821
        comm_manager = ip.kernel.comm_manager
    except Exception:
        return

    def on_open(comm, open_msg):
        view_id = (open_msg.get("content", {}).get("data", {})
                   .get("id"))
        widget = _WIDGET_REGISTRY.get(view_id)
        if widget is None:
            return
        object.__setattr__(widget, "_comm", comm)

        @comm.on_msg
        def _recv(msg, widget=widget):
            data = msg.get("content", {}).get("data", {})
            if "name" in data:
                # handler stdout/stderr/exceptions render above the widget
                # (reference labwidget.py:190)
                with capture_output(widget):
                    widget.set(data["name"], data.get("value"),
                               _from_view=True)

    comm_manager.register_target("labwidget", on_open)
    _COMM_TARGET_REGISTERED[0] = True


class Widget(Model):
    """A Model with an HTML view."""

    # handler output/errors render above the widget (capture_output)
    write = Trigger()

    def __init__(self, style=None, **kwargs):
        object.__setattr__(self, "_view_id", f"lw{next(_id_counter)}")
        object.__setattr__(self, "_comm", None)
        super().__init__(**kwargs)
        self.style = style or {}
        _WIDGET_REGISTRY[self._view_id] = self
        self._maybe_register_comm()

    def _maybe_register_comm(self):
        try:  # pragma: no cover - requires live kernel
            get_ipython  # noqa: F821
        except NameError:
            return
        _register_comm_target()

    def _send_to_view(self, name, value):  # pragma: no cover - live kernel
        if self._comm is not None:
            try:
                self._comm.send({"name": name, "value": value})
            except Exception:
                pass

    # -- rendering ---------------------------------------------------------------
    def widget_html(self) -> str:
        return f'<div id="{self._view_id}"></div>'

    def widget_js(self) -> str:
        return ""

    def std_attrs(self) -> str:
        style = ";".join(f"{k}:{v}" for k, v in self.style.items())
        return f'id="{self._view_id}" style="{style}"'

    def _repr_html_(self) -> str:
        props = {n: self.prop(n).value for n in self.property_names()
                 if isinstance(self.prop(n).value,
                               (int, float, str, bool, type(None)))}
        js = _COMM_JS % {"id": self._view_id,
                         "props": json.dumps(props),
                         "setup": self.widget_js()}
        return self.widget_html() + f"<script>{js}</script>"

    def display(self):  # pragma: no cover - notebook only
        from IPython.display import display, HTML
        display(HTML(self._repr_html_()))


# ---------------------------------------------------------------------------
# standard widgets
# ---------------------------------------------------------------------------

class Button(Widget):
    label = Property("button")
    click = Trigger()

    def __init__(self, label="button", **kwargs):
        super().__init__(**kwargs)
        self.label = label

    def widget_html(self):
        return (f'<button {self.std_attrs()}>'
                f'{_html.escape(str(self.label))}</button>')

    def widget_js(self):
        return (f'document.getElementById("{self._view_id}")'
                f'.addEventListener("click", function() '
                f'{{ model.set("click", true); }});')


class Label(Widget):
    value = Property("")

    def __init__(self, value="", **kwargs):
        super().__init__(**kwargs)
        self.value = value

    def widget_html(self):
        return (f'<span {self.std_attrs()}>'
                f'{_html.escape(str(self.value))}</span>')

    def widget_js(self):
        return (f'model.on("value", function(v) {{ document.'
                f'getElementById("{self._view_id}").textContent = v; }});')


class Textbox(Widget):
    value = Property("")
    size = Property(20)

    def __init__(self, value="", size=20, **kwargs):
        super().__init__(**kwargs)
        self.value = value
        self.size = size

    def widget_html(self):
        return (f'<input {self.std_attrs()} '
                f'value="{_html.escape(str(self.value))}" '
                f'size="{self.size}">')

    def widget_js(self):
        return (f'var el = document.getElementById("{self._view_id}");'
                f'el.addEventListener("change", function() '
                f'{{ model.set("value", el.value); }});'
                f'model.on("value", function(v) {{ el.value = v; }});')


class Range(Widget):
    value = Property(50)
    min = Property(0)
    max = Property(100)

    def widget_html(self):
        return (f'<input type="range" {self.std_attrs()} '
                f'value="{self.value}" min="{self.min}" max="{self.max}">')

    def widget_js(self):
        return (f'var el = document.getElementById("{self._view_id}");'
                f'el.addEventListener("input", function() '
                f'{{ model.set("value", Number(el.value)); }});'
                f'model.on("value", function(v) {{ el.value = v; }});')


class Choice(Widget):
    choices = Property(None)
    selection = Property(None)

    def __init__(self, choices=None, selection=None, **kwargs):
        super().__init__(**kwargs)
        self.choices = choices or []
        self.selection = selection

    def widget_html(self):
        opts = "".join(
            f'<option value="{_html.escape(str(c))}"'
            + (" selected" if c == self.selection else "")
            + f'>{_html.escape(str(c))}</option>'
            for c in (self.choices or []))
        return f'<select {self.std_attrs()}>{opts}</select>'

    def widget_js(self):
        return (f'var el = document.getElementById("{self._view_id}");'
                f'el.addEventListener("change", function() '
                f'{{ model.set("selection", el.value); }});')


class Checkbox(Widget):
    value = Property(False)

    def widget_html(self):
        checked = " checked" if self.value else ""
        return f'<input type="checkbox" {self.std_attrs()}{checked}>'

    def widget_js(self):
        return (f'var el = document.getElementById("{self._view_id}");'
                f'el.addEventListener("change", function() '
                f'{{ model.set("value", el.checked); }});')


class Textarea(Widget):
    """Multi-line text input; value syncs on blur
    (reference labwidget.py:628-660)."""
    value = Property("")
    rows = Property(2)
    cols = Property(20)

    def __init__(self, value="", rows=2, cols=20, **kwargs):
        super().__init__(**kwargs)
        self.value = value
        self.rows = rows
        self.cols = cols

    def widget_html(self):
        return (f'<textarea {self.std_attrs()} rows="{self.rows}" '
                f'cols="{self.cols}">'
                f'{_html.escape(str(self.value))}</textarea>')

    def widget_js(self):
        return (f'var el = document.getElementById("{self._view_id}");'
                f'el.addEventListener("blur", function() '
                f'{{ model.set("value", el.value); }});'
                f'model.on("value", function(v) {{ el.value = v; }});'
                f'model.on("rows", function(v) {{ el.rows = v; }});'
                f'model.on("cols", function(v) {{ el.cols = v; }});')


class Menu(Widget):
    """A dropdown choice whose option list can be updated live
    (reference labwidget.py:740-786)."""
    choices = Property(None)
    selection = Property(None)

    def __init__(self, choices=None, selection=None, **kwargs):
        super().__init__(**kwargs)
        self.choices = choices or []
        self.selection = selection

    def _options_html(self):
        # the view reports selections as strings; compare as strings
        return "".join(
            f'<option value="{_html.escape(str(c))}"'
            + (" selected" if str(c) == str(self.selection) else "")
            + f'>{_html.escape(str(c))}</option>'
            for c in (self.choices or []))

    def widget_html(self):
        return (f'<form {self.std_attrs()}>'
                f'<select name="menu">{self._options_html()}</select>'
                f'</form>')

    def widget_js(self):
        return (
            f'var el = document.getElementById("{self._view_id}");'
            f'var sel = el.querySelector("select");'
            'function esc(u) { return String(u).split("&").join("&amp;")'
            '.split("<").join("&lt;").split(">").join("&gt;")'
            '.split(String.fromCharCode(34)).join("&quot;"); }'
            'function render() {'
            '  var s = model.props.selection;'
            '  sel.innerHTML = (model.props.choices || []).map(function(c)'
            '  { return \'<option value="\' + esc(c) + \'"\' +'
            '    (c == s ? " selected" : "") + ">" + esc(c) + "</option>";'
            '  }).join("");'
            '}'
            'model.on("choices", render);'
            'model.on("selection", function(v) {'
            '  sel.querySelectorAll("option").forEach(function(o)'
            '  { o.selected = (o.value == v); });'
            '});'
            'el.addEventListener("change", function()'
            '{ model.set("selection", sel.value); });')


class Datalist(Widget):
    """A text input with dropdown autocomplete choices
    (reference labwidget.py:789-860)."""
    choices = Property(None)
    value = Property(None)

    def __init__(self, choices=None, value=None, **kwargs):
        super().__init__(**kwargs)
        self.choices = choices or []
        self.value = value

    def datalist_id(self):
        return self._view_id + "-dl"

    def widget_html(self):
        opts = "".join(f'<option value="{_html.escape(str(c))}">'
                       for c in (self.choices or []))
        val = _html.escape(str(self.value)) if self.value else ""
        return (f'<form {self.std_attrs()} onsubmit="return false;">'
                f'<input name="inp" list="{self.datalist_id()}" '
                f'value="{val}" autocomplete="off">'
                f'<datalist id="{self.datalist_id()}">{opts}</datalist>'
                f'</form>')

    def widget_js(self):
        # The mousedown value-stash defeats the browser's prefix filtering
        # so the full choice list drops down (reference labwidget.py:805-835)
        return (
            f'var el = document.getElementById("{self._view_id}");'
            f'var inp = el.querySelector("input");'
            f'var dl = document.getElementById("{self.datalist_id()}");'
            'function esc(u) { return String(u).split("&").join("&amp;")'
            '.split("<").join("&lt;").split(">").join("&gt;")'
            '.split(String.fromCharCode(34)).join("&quot;"); }'
            'function render() {'
            '  dl.innerHTML = (model.props.choices || []).map(function(c)'
            '  { return \'<option value="\' + esc(c) + \'">\'; }).join("");'
            '}'
            'model.on("choices", render);'
            'model.on("value", function(v) { inp.value = v == null ? "" : v; });'
            'function restoreValue() {'
            '  if (inp.value == "") {'
            '    inp.value = inp.placeholder; inp.placeholder = ""; } }'
            'inp.addEventListener("mousedown", function() {'
            '  if (inp.value != "") {'
            '    inp.placeholder = inp.value; inp.value = ""; } });'
            'inp.addEventListener("mouseleave", restoreValue);'
            'inp.addEventListener("change", function() {'
            '  inp.placeholder = ""; model.set("value", inp.value); });')


class Div(Widget):
    innerHTML = Property("")

    def __init__(self, innerHTML="", **kwargs):
        super().__init__(**kwargs)
        self.innerHTML = innerHTML

    def show(self, html_content):
        self.innerHTML = html_content

    def widget_html(self):
        return f'<div {self.std_attrs()}>{self.innerHTML}</div>'

    def widget_js(self):
        return (f'model.on("innerHTML", function(v) {{ document.'
                f'getElementById("{self._view_id}").innerHTML = v; }});')


class ClickDiv(Div):
    """A Div that fires a click Trigger for clicks anywhere inside it; the
    nearest enclosing element's data-click value is the event payload
    (reference labwidget.py:905-925)."""
    click = Trigger()

    def widget_js(self):
        return super().widget_js() + (
            f'var el = document.getElementById("{self._view_id}");'
            'el.addEventListener("click", function(ev) {'
            '  var t = ev.target;'
            '  while (t && t != el && !(t.dataset && t.dataset.click))'
            '  { t = t.parentElement; }'
            '  model.set("click",'
            '    t && t.dataset ? t.dataset.click : undefined);'
            '});')


class Image(Widget):
    src = Property("")
    click = Trigger()

    def __init__(self, src="", **kwargs):
        super().__init__(**kwargs)
        self.src = src

    def render(self, img):
        """Set from a uint8 (H, W, 3) image or an (H, W, C) zc array."""
        from ..utils import renormalize
        self.src = renormalize.as_url(img)

    def widget_html(self):
        return f'<img {self.std_attrs()} src="{self.src}">'

    def widget_js(self):
        return (f'var el = document.getElementById("{self._view_id}");'
                f'el.addEventListener("click", function() '
                f'{{ model.set("click", true); }});'
                f'model.on("src", function(v) {{ el.src = v; }});')
