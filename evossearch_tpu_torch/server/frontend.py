"""Single-page frontend (component L4).

Original implementation of the reference UI's behaviors (SURVEY.md §1-L4 /
§2-K "frontend behaviors that define implicit contract", oldapp.py:227-1809):
folder box with check-index-on-blur and Enter-to-submit, text/image search
tabs, sort + result-limit dropdowns, result grid with expand (thumbnail ->
/image/ URL swap + lazy comment load), find-similar (re-download via /image/
then re-upload to /search_by_image), copy-path, comment panel, commented-
images view, and a settings modal that round-trips /settings.

Template placeholders: {result_options_html}, {timestamp} — substituted by
render_page() exactly like the reference's home() (oldapp.py:1811-1814).
"""

PAGE = r"""<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>evossearch-tpu — semantic image search</title>
<style>
  :root {
    --bg: #10141a; --panel: #1a2029; --panel2: #222a36; --line: #2e3947;
    --text: #dde5ee; --dim: #8b97a6; --accent: #4da3ff;
    --accent2: #7fd0a0; --danger: #e07a7a; --radius: 10px;
  }
  * { box-sizing: border-box; }
  body { margin: 0; background: var(--bg); color: var(--text);
         font: 15px/1.5 system-ui, -apple-system, "Segoe UI", sans-serif; }
  .wrap { max-width: 1240px; margin: 0 auto; padding: 24px 20px 60px; }
  header { display: flex; align-items: baseline; gap: 14px; margin-bottom: 18px; }
  header h1 { font-size: 22px; margin: 0; letter-spacing: .3px; }
  header .sub { color: var(--dim); font-size: 13px; }
  header .spacer { flex: 1; }
  button { cursor: pointer; border: 1px solid var(--line); border-radius: 8px;
           background: var(--panel2); color: var(--text); padding: 8px 14px;
           font-size: 14px; }
  button:hover { border-color: var(--accent); }
  button.primary { background: var(--accent); border-color: var(--accent);
                   color: #0b1220; font-weight: 600; }
  button:disabled { opacity: .5; cursor: wait; }
  input[type=text], select, textarea {
    background: var(--panel); border: 1px solid var(--line); color: var(--text);
    border-radius: 8px; padding: 8px 10px; font-size: 14px; }
  .card { background: var(--panel); border: 1px solid var(--line);
          border-radius: var(--radius); padding: 16px; margin-bottom: 16px; }
  .row { display: flex; gap: 10px; align-items: center; flex-wrap: wrap; }
  .row .grow { flex: 1; min-width: 220px; }
  .badge { font-size: 12px; border-radius: 999px; padding: 2px 10px;
           border: 1px solid var(--line); color: var(--dim); }
  .badge.ok { color: var(--accent2); border-color: var(--accent2); }
  .badge.no { color: var(--danger); border-color: var(--danger); }
  .tabs { display: flex; gap: 6px; margin-bottom: 12px; }
  .tabs button { border-radius: 8px 8px 0 0; border-bottom: none; }
  .tabs button.active { background: var(--accent); color: #0b1220; font-weight: 600; }
  #status { color: var(--dim); min-height: 22px; margin: 6px 0; font-size: 13px; }
  #status.err { color: var(--danger); }
  .grid { display: grid; grid-template-columns: repeat(auto-fill, minmax(230px, 1fr));
          gap: 14px; }
  .tile { background: var(--panel); border: 1px solid var(--line);
          border-radius: var(--radius); overflow: hidden; display: flex;
          flex-direction: column; }
  .tile img { width: 100%; aspect-ratio: 4/3; object-fit: cover; display: block;
              cursor: zoom-in; background: #000; }
  .tile.expanded { grid-column: 1 / -1; }
  .tile.expanded img { aspect-ratio: auto; object-fit: contain; max-height: 78vh;
                       cursor: zoom-out; }
  .tile .meta { padding: 8px 10px; font-size: 12.5px; color: var(--dim);
                display: flex; justify-content: space-between; gap: 8px; }
  .tile .meta .name { color: var(--text); overflow: hidden;
                      text-overflow: ellipsis; white-space: nowrap; }
  .tile .actions { display: flex; gap: 6px; padding: 0 10px 10px; }
  .tile .actions button { padding: 4px 9px; font-size: 12.5px; }
  .comments { padding: 0 10px 12px; display: none; }
  .tile.expanded .comments { display: block; }
  .comments ul { margin: 6px 0; padding-left: 18px; font-size: 13px;
                 color: var(--dim); }
  .comments .crow { display: flex; gap: 6px; }
  .comments input { flex: 1; }
  dialog { background: var(--panel); color: var(--text); border: 1px solid
           var(--line); border-radius: var(--radius); min-width: 420px;
           padding: 20px; }
  dialog::backdrop { background: rgba(0,0,0,.55); }
  dialog h2 { margin-top: 0; font-size: 18px; }
  dialog .field { display: flex; justify-content: space-between; gap: 12px;
                  margin-bottom: 10px; align-items: center; }
  dialog .field label { color: var(--dim); font-size: 13.5px; }
  dialog .buttons { display: flex; justify-content: flex-end; gap: 8px;
                    margin-top: 14px; }
  .hidden { display: none !important; }
</style>
</head>
<body>
<div class="wrap" data-build="{timestamp}">
  <header>
    <h1>evossearch-tpu</h1>
    <span class="sub">TPU-native CLIP image search</span>
    <span class="spacer"></span>
    <button id="commentedBtn" title="Show images with comments">&#9998; Commented</button>
    <button id="settingsBtn" title="Settings">&#9881; Settings</button>
  </header>

  <div class="card">
    <div class="row">
      <input type="text" id="folder" class="grow"
             placeholder="Absolute path to an image folder, e.g. /data/photos">
      <span id="indexBadge" class="badge">not checked</span>
      <button id="indexBtn" class="primary">Index folder</button>
    </div>
  </div>

  <div class="card">
    <div class="tabs">
      <button id="tabText" class="active">Text search</button>
      <button id="tabImage">Image search</button>
    </div>
    <div id="textPane" class="row">
      <input type="text" id="query" class="grow"
             placeholder="Describe what you're looking for…">
      <button id="searchBtn" class="primary">Search</button>
    </div>
    <div id="imagePane" class="row hidden">
      <input type="file" id="imageFile" accept="image/*">
      <button id="imageSearchBtn" class="primary">Search by image</button>
    </div>
    <div class="row" style="margin-top:10px">
      <label class="sub">Results:
        <select id="limit">
                            {result_options_html}
        </select>
      </label>
      <label class="sub">Sort by:
        <select id="sortBy">
          <option value="similarity" selected>similarity</option>
          <option value="time">newest first</option>
        </select>
      </label>
    </div>
  </div>

  <div id="status"></div>
  <div id="results" class="grid"></div>
</div>

<dialog id="settingsDlg">
  <h2>Settings</h2>
  <div class="field"><label>Host</label><input type="text" id="s_host"></div>
  <div class="field"><label>Port</label><input type="text" id="s_port"></div>
  <div class="field"><label>Debug</label><input type="checkbox" id="s_debug"></div>
  <div class="field"><label>CLIP model</label>
    <select id="s_model">
      <option>ViT-B/32</option><option>ViT-B/16</option><option>ViT-L/14</option><option>ViT-L/14@336px</option>
      <option>RN50</option><option>RN101</option><option>RN50x4</option><option>RN50x16</option><option>RN50x64</option>
    </select></div>
  <div class="field"><label>Min results</label><input type="text" id="s_min"></div>
  <div class="field"><label>Max results</label><input type="text" id="s_max"></div>
  <div class="field"><label>Default results</label><input type="text" id="s_def"></div>
  <div class="field"><label>Batch size</label><input type="text" id="s_batch"></div>
  <div class="field"><label>Thumbnail quality</label><input type="text" id="s_q"></div>
  <div class="field"><label>Max comment length</label><input type="text" id="s_clen"></div>
  <div id="settingsMsg" class="sub"></div>
  <div class="buttons">
    <button id="settingsCancel">Cancel</button>
    <button id="settingsSave" class="primary">Save</button>
  </div>
</dialog>

<script>
"use strict";
const $ = (id) => document.getElementById(id);
const state = { mode: "text" };

function setStatus(msg, isError=false) {
  const el = $("status");
  el.textContent = msg || "";
  el.className = isError ? "err" : "";
}

function folder() { return $("folder").value.trim(); }

// ---- folder / index ----
async function checkIndex() {
  if (!folder()) { $("indexBadge").textContent = "not checked";
                   $("indexBadge").className = "badge"; return; }
  try {
    const r = await fetch("/check_index", {method: "POST",
      headers: {"Content-Type": "application/json"},
      body: JSON.stringify({folder: folder()})});
    const d = await r.json();
    const b = $("indexBadge");
    b.textContent = d.indexed ? "indexed" : "not indexed";
    b.className = "badge " + (d.indexed ? "ok" : "no");
  } catch (e) { setStatus("check_index failed: " + e, true); }
}
$("folder").addEventListener("blur", checkIndex);
$("folder").addEventListener("keydown", (e) => {
  if (e.key === "Enter") { state.mode === "text" ? doSearch() : doImageSearch(); }
});

$("indexBtn").addEventListener("click", async () => {
  if (!folder()) return setStatus("Enter a folder path first", true);
  $("indexBtn").disabled = true;
  setStatus("Indexing… (first run compiles the model; this can take a while)");
  try {
    const r = await fetch("/index", {method: "POST",
      headers: {"Content-Type": "application/json"},
      body: JSON.stringify({folder: folder()})});
    const d = await r.json();
    if (d.success) { setStatus(`Indexed ${d.count} images.`); checkIndex(); }
    else setStatus(d.error || "Indexing failed", true);
  } catch (e) { setStatus("Indexing failed: " + e, true); }
  finally { $("indexBtn").disabled = false; }
});

// ---- tabs ----
function setMode(mode) {
  state.mode = mode;
  $("tabText").className = mode === "text" ? "active" : "";
  $("tabImage").className = mode === "image" ? "active" : "";
  $("textPane").classList.toggle("hidden", mode !== "text");
  $("imagePane").classList.toggle("hidden", mode !== "image");
}
$("tabText").addEventListener("click", () => setMode("text"));
$("tabImage").addEventListener("click", () => setMode("image"));

// ---- search ----
async function doSearch() {
  if (!folder() || !$("query").value.trim())
    return setStatus("Need a folder and a query", true);
  setStatus("Searching…");
  try {
    const r = await fetch("/search", {method: "POST",
      headers: {"Content-Type": "application/json"},
      body: JSON.stringify({folder: folder(), query: $("query").value.trim(),
        limit: $("limit").value, sort_by: $("sortBy").value})});
    const d = await r.json();
    if (d.error) return setStatus(d.error, true);
    renderResults(d.results);
  } catch (e) { setStatus("Search failed: " + e, true); }
}
$("searchBtn").addEventListener("click", doSearch);
$("query").addEventListener("keydown", (e) => { if (e.key === "Enter") doSearch(); });

async function searchByBlob(blob, filename) {
  const fd = new FormData();
  fd.append("folder", folder());
  fd.append("limit", $("limit").value);
  fd.append("sort_by", $("sortBy").value);
  fd.append("image", blob, filename || "query.jpg");
  const r = await fetch("/search_by_image", {method: "POST", body: fd});
  const d = await r.json();
  if (d.error) return setStatus(d.error, true);
  renderResults(d.results);
}

async function doImageSearch() {
  const f = $("imageFile").files[0];
  if (!folder() || !f) return setStatus("Need a folder and an image file", true);
  setStatus("Searching by image…");
  try { await searchByBlob(f, f.name); }
  catch (e) { setStatus("Image search failed: " + e, true); }
}
$("imageSearchBtn").addEventListener("click", doImageSearch);

// find-similar: re-download the original via /image/ and re-upload it
// (same flow as the reference frontend).
async function findSimilar(path) {
  setStatus("Finding similar images…");
  try {
    const r = await fetch("/image/" + encodeURIComponent(path));
    if (!r.ok) return setStatus("Could not fetch original image", true);
    await searchByBlob(await r.blob(), "similar.jpg");
  } catch (e) { setStatus("Find-similar failed: " + e, true); }
}

// ---- results ----
function fmtSize(n) {
  if (!n) return "";
  const units = ["B", "KB", "MB", "GB"]; let i = 0;
  while (n >= 1024 && i < units.length - 1) { n /= 1024; i++; }
  return n.toFixed(i ? 1 : 0) + " " + units[i];
}

function renderResults(results) {
  const grid = $("results");
  grid.textContent = "";
  if (!results || !results.length) { setStatus("No results."); return; }
  setStatus(`${results.length} result${results.length > 1 ? "s" : ""}.`);
  for (const res of results) grid.appendChild(makeTile(res));
}

function makeTile(res) {
  const tile = document.createElement("div");
  tile.className = "tile";
  const img = document.createElement("img");
  img.src = "data:image/jpeg;base64," + res.thumbnail;
  img.alt = res.filename;
  img.loading = "lazy";
  tile.appendChild(img);

  const meta = document.createElement("div");
  meta.className = "meta";
  const name = document.createElement("span");
  name.className = "name"; name.textContent = res.filename;
  name.title = res.path + (res.metadata && res.metadata.size
    ? " (" + fmtSize(res.metadata.size) + ")" : "");
  const side = document.createElement("span");
  side.textContent = res.similarity !== undefined
    ? res.similarity.toFixed(3)
    : (res.comment_count !== undefined ? res.comment_count + " 💬" : "");
  meta.append(name, side);
  tile.appendChild(meta);

  const actions = document.createElement("div");
  actions.className = "actions";
  const simBtn = document.createElement("button");
  simBtn.textContent = "Similar";
  simBtn.addEventListener("click", () => findSimilar(res.path));
  const copyBtn = document.createElement("button");
  copyBtn.textContent = "Copy path";
  copyBtn.addEventListener("click", async () => {
    try { await navigator.clipboard.writeText(res.path);
          copyBtn.textContent = "Copied!"; }
    catch { copyBtn.textContent = "Copy failed"; }
    setTimeout(() => copyBtn.textContent = "Copy path", 1200);
  });
  actions.append(simBtn, copyBtn);
  tile.appendChild(actions);

  const comments = document.createElement("div");
  comments.className = "comments";
  tile.appendChild(comments);

  // expand: swap thumbnail for the original via /image/, lazy-load comments
  img.addEventListener("click", () => {
    const expanded = tile.classList.toggle("expanded");
    if (expanded) {
      img.src = "/image/" + encodeURIComponent(res.path);
      loadComments(res.path, comments);
    } else {
      img.src = "data:image/jpeg;base64," + res.thumbnail;
    }
  });
  return tile;
}

// ---- comments ----
async function loadComments(path, container) {
  container.textContent = "";
  const list = document.createElement("ul");
  const crow = document.createElement("div");
  crow.className = "crow";
  const input = document.createElement("input");
  input.type = "text"; input.placeholder = "Add a comment…";
  const btn = document.createElement("button");
  btn.textContent = "Post";
  const post = async () => {
    const text = input.value.trim();
    if (!text) return;
    const r = await fetch("/comments", {method: "POST",
      headers: {"Content-Type": "application/json"},
      body: JSON.stringify({folder: folder(), image_path: path, comment: text})});
    const d = await r.json();
    if (d.error) return setStatus(d.error, true);
    input.value = ""; fill(d.comments);
  };
  btn.addEventListener("click", post);
  input.addEventListener("keydown", (e) => { if (e.key === "Enter") post(); });
  crow.append(input, btn);
  container.append(list, crow);
  const fill = (comments) => {
    list.textContent = "";
    for (const c of comments || []) {
      const li = document.createElement("li"); li.textContent = c;
      list.appendChild(li);
    }
  };
  try {
    const r = await fetch(`/comments?folder=${encodeURIComponent(folder())}` +
                          `&image_path=${encodeURIComponent(path)}`);
    fill((await r.json()).comments);
  } catch { /* comments are best-effort */ }
}

$("commentedBtn").addEventListener("click", async () => {
  if (!folder()) return setStatus("Enter a folder path first", true);
  setStatus("Loading commented images…");
  try {
    const r = await fetch("/commented_images", {method: "POST",
      headers: {"Content-Type": "application/json"},
      body: JSON.stringify({folder: folder()})});
    const d = await r.json();
    if (d.error) return setStatus(d.error, true);
    renderResults(d.results);
  } catch (e) { setStatus("Failed: " + e, true); }
});

// ---- settings ----
$("settingsBtn").addEventListener("click", async () => {
  try {
    const r = await fetch("/settings");
    const d = await r.json();
    if (!d.success) return setStatus(d.error || "Could not load settings", true);
    const s = d.settings;
    $("s_host").value = s.host; $("s_port").value = s.port;
    $("s_debug").checked = !!s.debug; $("s_model").value = s.clipModel;
    $("s_min").value = s.minResults; $("s_max").value = s.maxResults;
    $("s_def").value = s.defaultResults; $("s_batch").value = s.batchSize;
    $("s_q").value = s.thumbnailQuality; $("s_clen").value = s.maxCommentLength;
    $("settingsMsg").textContent = "";
    $("settingsDlg").showModal();
  } catch (e) { setStatus("Settings load failed: " + e, true); }
});
$("settingsCancel").addEventListener("click", () => $("settingsDlg").close());
$("settingsSave").addEventListener("click", async () => {
  const body = {
    host: $("s_host").value, port: $("s_port").value,
    debug: $("s_debug").checked, clipModel: $("s_model").value,
    minResults: $("s_min").value, maxResults: $("s_max").value,
    defaultResults: $("s_def").value, batchSize: $("s_batch").value,
    thumbnailQuality: $("s_q").value, maxCommentLength: $("s_clen").value,
  };
  try {
    const r = await fetch("/settings", {method: "POST",
      headers: {"Content-Type": "application/json"},
      body: JSON.stringify(body)});
    const d = await r.json();
    $("settingsMsg").textContent = d.success ? d.message : d.error;
    if (d.success) setTimeout(() => $("settingsDlg").close(), 1500);
  } catch (e) { $("settingsMsg").textContent = "Save failed: " + e; }
});
</script>
</body>
</html>
"""


def render_page(result_options_html: str, timestamp: str) -> str:
    page = PAGE.replace("{result_options_html}", result_options_html)
    return page.replace("{timestamp}", timestamp)
