"""The runners: ``serve`` (an engine under open-loop traffic) and
``train`` (an optimizer's steps), chosen by a cell's ``runner``."""
