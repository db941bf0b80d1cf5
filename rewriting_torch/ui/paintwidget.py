"""PaintWidget: paint a mask over an image; the mask travels as a base64
PNG data URL (the edit-request format).

The port's copy of the JAX package's ``ui/paintwidget.py`` (reference
utils/paintwidget.py): Properties ``image``, ``mask``, ``brushsize``,
``oneshot``, ``disabled``; painting in the browser updates ``mask``;
Python can set either side.  ``set_image`` takes a uint8 (H, W, 3) image
or an (H, W, 3) zc array."""

from __future__ import annotations

from .labwidget import Property, Widget


class PaintWidget(Widget):
    image = Property("")
    mask = Property("")
    brushsize = Property(10.0)
    oneshot = Property(False)
    vanishing = Property(True)
    disabled = Property(False)
    width = Property(256)
    height = Property(256)

    def __init__(self, image="", mask="", **kwargs):
        super().__init__(**kwargs)
        if image:
            self.image = image
        if mask:
            self.mask = mask

    def set_image(self, img):
        from ..utils import renormalize
        self.image = renormalize.as_url(img)
        self.mask = ""

    def clear(self):
        self.mask = ""

    def widget_html(self):
        return (
            f'<div {self.std_attrs()} style="position:relative;'
            f'width:{self.width}px;height:{self.height}px">'
            f'<img id="{self._view_id}_img" src="{self.image}" '
            f'style="position:absolute;width:100%;height:100%">'
            f'<canvas id="{self._view_id}_canvas" width="{self.width}" '
            f'height="{self.height}" '
            f'style="position:absolute;left:0;top:0"></canvas></div>')

    def widget_js(self):
        # canvas painting: white strokes on transparent; mask exported as
        # a PNG data URL on mouseup
        return f"""
var canvas = document.getElementById("{self._view_id}_canvas");
var img = document.getElementById("{self._view_id}_img");
var ctx = canvas.getContext("2d");
var painting = false;
function paint(e) {{
  if (model.props.disabled) return;
  var r = canvas.getBoundingClientRect();
  var x = (e.clientX - r.left) * canvas.width / r.width;
  var y = (e.clientY - r.top) * canvas.height / r.height;
  ctx.fillStyle = "white";
  ctx.beginPath();
  ctx.arc(x, y, model.props.brushsize, 0, 2 * Math.PI);
  ctx.fill();
}}
canvas.addEventListener("mousedown", function(e) {{
  if (model.props.oneshot) ctx.clearRect(0, 0, canvas.width, canvas.height);
  painting = true; paint(e);
}});
canvas.addEventListener("mousemove", function(e) {{
  if (painting) paint(e);
}});
window.addEventListener("mouseup", function(e) {{
  if (!painting) return;
  painting = false;
  model.set("mask", canvas.toDataURL("image/png"));
}});
model.on("mask", function(v) {{
  if (!v) ctx.clearRect(0, 0, canvas.width, canvas.height);
}});
model.on("image", function(v) {{
  img.src = v;
  ctx.clearRect(0, 0, canvas.width, canvas.height);
}});
"""
