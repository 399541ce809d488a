"""Browser console: a single-file SPA served at /minio-tpu/console
over the existing JSON-RPC web backend (ref browser/ — the reference
ships a 131-file React app; the rebuild keeps the same capabilities —
login, bucket CRUD, object browse/upload/download/delete, server
info — as one dependency-free page talking to s3/webrpc.py).

The port's own copy of ``minio_tpu/s3/console.py``, with no change in
behaviour."""

CONSOLE_HTML = r"""<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>minio-tpu console</title>
<style>
:root { --bg:#101418; --panel:#1a2026; --edge:#2a323b; --fg:#e6edf3;
        --dim:#8b98a5; --acc:#4da3ff; --bad:#ff6b6b; --ok:#51cf66; }
* { box-sizing:border-box; margin:0; }
body { background:var(--bg); color:var(--fg);
       font:14px/1.5 system-ui,-apple-system,Segoe UI,sans-serif; }
header { display:flex; align-items:center; gap:12px; padding:10px 18px;
         background:var(--panel); border-bottom:1px solid var(--edge); }
header h1 { font-size:16px; font-weight:600; }
header .spacer { flex:1; }
main { display:grid; grid-template-columns:260px 1fr; gap:0;
       height:calc(100vh - 49px); }
#buckets { background:var(--panel); border-right:1px solid var(--edge);
           overflow:auto; padding:10px; }
#buckets .bucket { padding:7px 10px; border-radius:6px; cursor:pointer;
                   display:flex; justify-content:space-between; }
#buckets .bucket:hover { background:var(--edge); }
#buckets .bucket.active { background:var(--acc); color:#04121f; }
#objects { overflow:auto; padding:14px 18px; }
table { width:100%; border-collapse:collapse; }
th, td { text-align:left; padding:6px 10px;
         border-bottom:1px solid var(--edge); }
th { color:var(--dim); font-weight:500; }
button, input { font:inherit; border-radius:6px;
                border:1px solid var(--edge);
                background:var(--bg); color:var(--fg);
                padding:6px 10px; }
button { cursor:pointer; background:var(--edge); }
button.primary { background:var(--acc); color:#04121f;
                 border-color:var(--acc); }
button.danger { color:var(--bad); }
#login { max-width:360px; margin:12vh auto; background:var(--panel);
         padding:26px; border-radius:10px;
         border:1px solid var(--edge); display:flex;
         flex-direction:column; gap:12px; }
#msg { color:var(--bad); min-height:1.2em; }
.toolbar { display:flex; gap:8px; margin-bottom:12px;
           align-items:center; }
.dim { color:var(--dim); }
#drop.drag { outline:2px dashed var(--acc); outline-offset:-6px; }
.hidden { display:none !important; }
#info { font-size:12px; color:var(--dim); }
</style>
</head>
<body>
<div id="login">
  <h1>minio-tpu console</h1>
  <input id="user" placeholder="access key" autocomplete="username">
  <input id="pass" placeholder="secret key" type="password"
         autocomplete="current-password">
  <button class="primary" id="loginBtn">Sign in</button>
  <div id="msg"></div>
</div>
<div id="app" class="hidden">
<header>
  <h1>minio-tpu</h1>
  <span id="info"></span>
  <span class="spacer"></span>
  <button id="logout">Sign out</button>
</header>
<main>
  <div id="buckets">
    <div class="toolbar">
      <input id="newBucket" placeholder="new bucket"
             style="width:140px">
      <button class="primary" id="mkBucket">+</button>
    </div>
    <div id="bucketList"></div>
  </div>
  <div id="objects">
    <div class="toolbar">
      <strong id="curBucket" class="dim">select a bucket</strong>
      <span class="spacer" style="flex:1"></span>
      <input id="fileInput" type="file" multiple class="hidden">
      <button class="primary" id="uploadBtn" disabled>Upload</button>
      <button class="danger" id="rmBucket" disabled>Delete bucket</button>
    </div>
    <div id="drop">
      <table>
        <thead><tr><th>Object</th><th>Size</th><th>Modified</th>
        <th></th></tr></thead>
        <tbody id="objList"></tbody>
      </table>
    </div>
  </div>
</main>
</div>
<script>
"use strict";
let token = sessionStorage.getItem("mtpu-token") || "";
let bucket = "";
const $ = id => document.getElementById(id);

async function rpc(method, params) {
  const r = await fetch("/minio-tpu/webrpc", {
    method: "POST",
    headers: {"Content-Type": "application/json",
              "Authorization": "Bearer " + token},
    body: JSON.stringify({jsonrpc: "2.0", id: 1,
                          method: "web." + method,
                          params: params || {}})});
  const doc = await r.json();
  if (doc.error) throw new Error(doc.error.message || "rpc failed");
  return doc.result;
}

// UI actions surface failures instead of rejecting silently; an
// auth-sounding failure bounces back to the login screen.
function act(fn) {
  return (...args) => Promise.resolve(fn(...args)).catch(e => {
    const m = String(e.message || e);
    if (/token|auth|expired/i.test(m)) {
      token = "";
      sessionStorage.removeItem("mtpu-token");
      show(false);
      $("msg").textContent = "session expired — sign in again";
      return;
    }
    alert(m);
  });
}

function fmtSize(n) {
  if (n < 1024) return n + " B";
  const u = ["KiB", "MiB", "GiB", "TiB"];
  let i = -1;
  do { n /= 1024; i++; } while (n >= 1024 && i < u.length - 1);
  return n.toFixed(1) + " " + u[i];
}

function show(loggedIn) {
  $("login").classList.toggle("hidden", loggedIn);
  $("app").classList.toggle("hidden", !loggedIn);
}

async function login() {
  $("msg").textContent = "";
  try {
    const res = await rpc("Login", {username: $("user").value,
                                    password: $("pass").value});
    token = res.token;
    sessionStorage.setItem("mtpu-token", token);
    show(true);
    await refresh();
  } catch (e) { $("msg").textContent = e.message; }
}

async function refresh() {
  try {
    const info = await rpc("ServerInfo", {});
    $("info").textContent =
      (info.version ? "v" + info.version : "") +
      (info.mode ? " · " + info.mode : "");
  } catch (e) { /* non-fatal */ }
  const res = await rpc("ListBuckets", {});
  const list = $("bucketList");
  list.innerHTML = "";
  (res.buckets || []).forEach(b => {
    const el = document.createElement("div");
    el.className = "bucket" + (b.name === bucket ? " active" : "");
    el.textContent = b.name;
    el.onclick = act(() => {
      bucket = b.name;
      $("uploadBtn").disabled = $("rmBucket").disabled = false;
      $("curBucket").textContent = bucket;
      list.querySelectorAll(".bucket").forEach(
        x => x.classList.toggle("active", x === el));
      return listObjects();
    });
    list.appendChild(el);
  });
  $("uploadBtn").disabled = $("rmBucket").disabled = !bucket;
  $("curBucket").textContent = bucket || "select a bucket";
}

async function listObjects() {
  if (!bucket) return;
  const res = await rpc("ListObjects", {bucketName: bucket});
  const tb = $("objList");
  tb.innerHTML = "";
  (res.objects || []).forEach(o => {
    const tr = document.createElement("tr");
    const dl = document.createElement("button");
    dl.textContent = "download";
    dl.onclick = act(() => download(o.name));
    const rm = document.createElement("button");
    rm.textContent = "delete";
    rm.className = "danger";
    rm.onclick = act(async () => {
      await rpc("RemoveObject", {bucketName: bucket,
                                 objects: [o.name]});
      return listObjects();
    });
    const cells = [o.name, fmtSize(o.size || 0),
                   o.lastModified
                     ? new Date(o.lastModified).toLocaleString()
                     : ""];
    cells.forEach(t => {
      const td = document.createElement("td");
      td.textContent = t;
      tr.appendChild(td);
    });
    const actTd = document.createElement("td");
    actTd.appendChild(dl);
    actTd.appendChild(document.createTextNode(" "));
    actTd.appendChild(rm);
    tr.appendChild(actTd);
    tb.appendChild(tr);
  });
}

async function download(key) {
  const res = await rpc("CreateURLToken", {});
  const url = "/minio-tpu/web/download/" + bucket + "/" +
      encodeURIComponent(key).replace(/%2F/g, "/") +
      "?token=" + encodeURIComponent(res.token);
  const a = document.createElement("a");
  a.href = url;
  a.download = key.split("/").pop();
  a.click();
}

async function uploadFiles(files) {
  for (const f of files) {
    const r = await fetch("/minio-tpu/web/upload/" + bucket + "/" +
                encodeURIComponent(f.name), {
      method: "PUT",
      headers: {"Authorization": "Bearer " + token,
                "Content-Type": f.type || "application/octet-stream"},
      body: f});
    if (!r.ok) {
      let why = "HTTP " + r.status;
      try { why = (await r.json()).error || why; } catch (e) {}
      alert("upload of " + f.name + " failed: " + why);
    }
  }
  listObjects();
}

$("loginBtn").onclick = login;
$("pass").addEventListener("keydown",
                           e => { if (e.key === "Enter") login(); });
$("logout").onclick = () => {
  token = ""; bucket = "";
  sessionStorage.removeItem("mtpu-token");
  show(false);
};
$("mkBucket").onclick = act(async () => {
  const name = $("newBucket").value.trim();
  if (!name) return;
  await rpc("MakeBucket", {bucketName: name});
  $("newBucket").value = "";
  return refresh();
});
$("rmBucket").onclick = async () => {
  if (!bucket || !confirm("Delete bucket " + bucket + "?")) return;
  try { await rpc("DeleteBucket", {bucketName: bucket}); }
  catch (e) { alert(e.message); return; }
  bucket = "";
  refresh();
  $("objList").innerHTML = "";
};
$("uploadBtn").onclick = () => $("fileInput").click();
$("fileInput").onchange = act(async e => {
  await uploadFiles(e.target.files);
  e.target.value = "";   // same file re-selected must re-fire
});
const drop = $("drop");
drop.addEventListener("dragover",
                      e => { e.preventDefault();
                             drop.classList.add("drag"); });
drop.addEventListener("dragleave",
                      () => drop.classList.remove("drag"));
drop.addEventListener("drop", act(e => {
  e.preventDefault();
  drop.classList.remove("drag");
  if (bucket) return uploadFiles(e.dataTransfer.files);
}));

if (token) {
  show(true);
  refresh().catch(() => show(false));
}
</script>
</body>
</html>
"""


def console_response() -> tuple[int, str, bytes]:
    return 200, "text/html; charset=utf-8", CONSOLE_HTML.encode()
