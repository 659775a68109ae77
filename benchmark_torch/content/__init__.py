"""Input content: ``<name>.py`` holds ``make(gen, n, h, w, device)``, which
returns uint8 [n, *item] items drawn from the seeded generator ``gen``, and
``PLANES``, the [h, w] planes of one item; a traffic mix names its content
under ``content``."""
