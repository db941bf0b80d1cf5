"""The notebook UI: the widget framework, the paint widget and the
rewriting app, over the port's rewriters."""

from .labwidget import (Button, Checkbox, Choice, ClickDiv, Datalist, Div,
                        Image, Label, Menu, Model, Property, Range, Textarea,
                        Textbox, Trigger, Widget, block_events,
                        capture_output)
from .paintwidget import PaintWidget
from .rewriteapp import GanRewriteApp

__all__ = ["Model", "Property", "Trigger", "Widget", "Button", "Label",
           "Textbox", "Textarea", "Range", "Choice", "Menu", "Datalist",
           "Checkbox", "Div", "ClickDiv", "Image", "block_events",
           "capture_output", "PaintWidget", "GanRewriteApp"]
